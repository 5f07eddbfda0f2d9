"""Command, sampling, termination, exteroception and control components (the
JAX package's ``robot/tpu/components.py``).

Each component is a small class closing over static config; per-env state
lives in the env's ``internal`` dict of ``[B, ...]`` tensors, and every
random draw comes from a ``Draws`` (``draws.py``).
"""

import numpy as np
import torch


# --- sampling schedules -------------------------------------------------------

class NoneSampling:
    def __init__(self, env):
        self.device = env.device

    def setup(self, draws, B, curriculum_coeff=1.0):
        return torch.zeros(B, dtype=torch.bool, device=self.device)

    def step(self, draws, B, curriculum_coeff=1.0):
        return torch.zeros(B, dtype=torch.bool, device=self.device)


class EveryStepSampling(NoneSampling):
    def setup(self, draws, B, curriculum_coeff=1.0):
        return torch.ones(B, dtype=torch.bool, device=self.device)

    def step(self, draws, B, curriculum_coeff=1.0):
        return torch.ones(B, dtype=torch.bool, device=self.device)


class StepProbabilitySampling(NoneSampling):
    def __init__(self, env, probability=0.002):
        super().__init__(env)
        self.probability = probability

    def step(self, draws, B, curriculum_coeff=1.0):
        return draws.uniform((B,)) < self.probability * curriculum_coeff


class StepProbabilityAndResetSampling(StepProbabilitySampling):
    def setup(self, draws, B, curriculum_coeff=1.0):
        return torch.ones(B, dtype=torch.bool, device=self.device)


SAMPLING_FUNCTIONS = {
    "none": NoneSampling,
    "every_step": EveryStepSampling,
    "step_probability": StepProbabilitySampling,
    "step_probability_and_reset": StepProbabilityAndResetSampling,
}


def get_sampling_function(name, env):
    return SAMPLING_FUNCTIONS[name](env)


# --- commands -------------------------------------------------------------------

class RandomCommands:
    """Uniform (vx, vy, vyaw) commands with zero-clipping and zeroing chances."""

    def __init__(self, env, cfg):
        self.env = env
        self.max_velocity_per_m_factor = cfg["max_velocity_per_m_factor"]
        self.clip_max_velocity = cfg["clip_max_velocity"]
        self.zero_clip_threshold_percentage = cfg["zero_clip_threshold_percentage"]
        self.all_zero_chance = cfg["all_zero_chance"]
        self.single_zero_chance = cfg["single_zero_chance"]

        keep = np.zeros(env.nr_actuator_joints, dtype=np.float32)
        keep[np.asarray(env.robot_config["actuator_joints_to_stay_near_nominal"], int)] = 1.0
        self.default_keep_nominal = torch.as_tensor(keep, dtype=env.dtype, device=env.device)

    def max_command_velocity(self):
        return min(self.env.robot_dimensions_mean * self.max_velocity_per_m_factor, self.clip_max_velocity)

    def init_state(self, nr_envs):
        return {
            "goal_velocities": torch.zeros((nr_envs, 3), device=self.env.device),
            "actuator_joint_keep_nominal": self.default_keep_nominal[None].repeat(nr_envs, 1),
        }

    def get_next_command(self, internal, should_sample, draws):
        """should_sample [B] -> updated goal_velocities / keep-nominal masks."""
        B = should_sample.shape[0]
        max_v = internal["max_command_velocity"][:, None]                  # [B, 1]
        goals = draws.uniform((B, 3), -1.0, 1.0) * max_v
        goals = torch.where(torch.abs(goals) < self.zero_clip_threshold_percentage * max_v, 0.0, goals)
        all_zero = draws.bernoulli(self.all_zero_chance, (B,))
        goals = torch.where(all_zero[:, None], 0.0, goals)
        goals = torch.where(draws.uniform((B, 3)) < self.single_zero_chance, 0.0, goals)

        standing = torch.all(goals == 0.0, dim=1)
        keep = torch.where(standing[:, None], 1.0, self.default_keep_nominal[None])

        internal = dict(internal)
        internal["goal_velocities"] = torch.where(should_sample[:, None], goals, internal["goal_velocities"])
        internal["actuator_joint_keep_nominal"] = torch.where(
            should_sample[:, None], keep, internal["actuator_joint_keep_nominal"]
        )
        return internal


COMMAND_FUNCTIONS = {"random": RandomCommands}


def get_command_function(name, env, cfg):
    return COMMAND_FUNCTIONS[name](env, cfg)


# --- termination ------------------------------------------------------------------

class BelowHeightTermination:
    def __init__(self, env, cfg):
        self.env = env
        self.height_percentage_threshold = cfg["height_percentage_threshold"]

    def should_terminate(self, internal):
        threshold = (
            (1.0 - internal["env_curriculum_coeff"])
            * self.height_percentage_threshold
            * self.env.nominal_imu_height_over_ground
        )
        return internal["imu_height_over_ground"] < threshold


TERMINATION_FUNCTIONS = {"below_height": BelowHeightTermination}


def get_termination_function(name, env, cfg):
    return TERMINATION_FUNCTIONS[name](env, cfg)


# --- exteroceptive observations ------------------------------------------------------

class NoneExteroception:
    nr_exteroceptive_observations = 0

    def __init__(self, env, cfg=None):
        self.env = env

    def get(self, internal, trunk_pos, trunk_yaw):
        return torch.zeros((trunk_pos.shape[0], 0), device=trunk_pos.device)


class HeightOverGroundExteroception(NoneExteroception):
    nr_exteroceptive_observations = 1

    def get(self, internal, trunk_pos, trunk_yaw):
        return internal["imu_height_over_ground"][:, None]


class HeightSamplesExteroception(NoneExteroception):
    """A 5 x 5 grid of terrain heights around the robot, rotated with its
    yaw, relative to the trunk height."""

    def __init__(self, env, cfg=None):
        self.env = env
        grid = np.asarray(
            [[x, y] for x in np.linspace(-0.5, 0.5, 5) for y in np.linspace(-0.35, 0.35, 5)], dtype=np.float32,
        )  # [25, 2] body-frame sample points
        self.grid = torch.as_tensor(grid, dtype=env.dtype, device=env.device)
        self.nr_exteroceptive_observations = len(grid)

    def get(self, internal, trunk_pos, trunk_yaw):
        c, s = torch.cos(trunk_yaw), torch.sin(trunk_yaw)        # [B]
        gx = self.grid[None, :, 0]                               # [1, 25]
        gy = self.grid[None, :, 1]
        wx = trunk_pos[:, 0:1] + c[:, None] * gx - s[:, None] * gy
        wy = trunk_pos[:, 1:2] + s[:, None] * gx + c[:, None] * gy
        ground = self.env.terrain_function.height_at(internal, wx, wy)  # [B, 25]
        return trunk_pos[:, 2:3] - ground


EXTEROCEPTION_FUNCTIONS = {
    "none": NoneExteroception,
    "height_over_ground": HeightOverGroundExteroception,
    "height_samples": HeightSamplesExteroception,
}


def get_exteroceptive_observation_function(name, env):
    return EXTEROCEPTION_FUNCTIONS[name](env)


# --- control ----------------------------------------------------------------------------

class PDControl:
    """Action -> target joint positions for the engine's position servos."""

    def __init__(self, env):
        self.env = env

    def process_action(self, action, internal):
        scaled = action * internal["scaling_factor"][..., None]
        target = internal["actuator_joint_nominal_positions"] + scaled
        return target + internal["position_offsets"]


CONTROL_FUNCTIONS = {"pd": PDControl}


def get_control_function(name, env):
    return CONTROL_FUNCTIONS[name](env)
