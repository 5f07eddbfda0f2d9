"""Ant velocity-tracking locomotion on the batched PyTorch physics engine.

- 34-dim observation: height, joint positions (relative to nominal), joint
  velocities, local linear/angular velocities, projected gravity, last ctrl;
- reward: xy velocity-command tracking  exp(-||v_cmd - v_local_xy||^2 / 0.25)
  with command (2.0, 0.0) m/s;
- termination: torso height outside (0.2, 1.0); 4 physics substeps per
  control step; actions are target joint offsets scaled by
  ``action_scaling_factor`` around the nominal pose.

The model is read from ``data/ant_model.npz``, compiled from ``data/ant.xml``
(keyframe "home") with ``physics.model.load_mjcf`` and saved with
``save_model``, so the env needs no MuJoCo bindings.
"""

import os
from typing import NamedTuple

import torch

from rlx_tpu_torch.environments.env import DeviceEnv, draw
from rlx_tpu_torch.environments.spaces import BoxSpace
from rlx_tpu_torch.physics import engine, load_model
from rlx_tpu_torch.physics.model import HINGE
from rlx_tpu_torch.physics.spatial import quat_to_rot

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
ANT_XML = os.path.join(DATA_DIR, "ant.xml")
ANT_MODEL = os.path.join(DATA_DIR, "ant_model.npz")


class AntPhysics(NamedTuple):
    qpos: torch.Tensor
    qvel: torch.Tensor
    ctrl: torch.Tensor


class Ant(DeviceEnv):
    parallel_seeds = True

    def __init__(self, nr_envs, horizon=1000, action_scaling_factor=0.3, nr_substeps=4,
                 initial_state_noise=0.0, perturbation_chance=0.0, perturbation_velocity=0.5,
                 device="cuda"):
        self.nr_envs = nr_envs
        self.horizon = horizon
        self.action_scaling_factor = action_scaling_factor
        self.nr_substeps = nr_substeps
        self.initial_state_noise = initial_state_noise
        self.perturbation_chance = perturbation_chance
        self.perturbation_velocity = perturbation_velocity
        self.device = torch.device(device)

        self.model = load_model(ANT_MODEL)
        self.qpos0 = torch.as_tensor(self.model.qpos0, device=self.device)
        self.nominal_joint_positions = self.qpos0[7:]
        self.nr_joints = self.model.nv - 6

        self.target_local_velocity = torch.tensor([2.0, 0.0], device=self.device)
        self.down = torch.tensor([0.0, 0.0, -1.0], device=self.device)

        hinge_rows = sorted(
            (int(self.model.dof_adr[i]), i)
            for i in range(self.model.nbody)
            if int(self.model.jnt_type[i]) == HINGE
        )
        self.single_action_space = BoxSpace(
            low=[self.model.jnt_range[i, 0] for _, i in hinge_rows],
            high=[self.model.jnt_range[i, 1] for _, i in hinge_rows],
            shape=(self.nr_joints,),
            center=self.nominal_joint_positions,
            scale=torch.full((self.nr_joints,), action_scaling_factor),
            device=self.device,
        )
        self.single_observation_space = BoxSpace(
            low=-float("inf"), high=float("inf"),
            shape=(1 + 2 * self.nr_joints + 9 + self.nr_joints,), device=self.device,
        )

    def initial_physics(self, generator, eval_mode):
        B = self.nr_envs
        qpos = self.qpos0[None].repeat(B, 1)
        qvel = torch.zeros((B, self.model.nv), device=self.device)
        if self.initial_state_noise > 0.0 and not eval_mode:
            noise = draw(generator, torch.randn, (B, self.nr_joints), device=self.device)
            qpos[:, 7:] += self.initial_state_noise * noise
            qvel = qvel + self.initial_state_noise * draw(generator, torch.randn, qvel.shape, device=self.device)
        ctrl = self.nominal_joint_positions[None].repeat(B, 1)
        return AntPhysics(qpos=qpos, qvel=qvel, ctrl=ctrl)

    def _local(self, qpos, vectors):
        """World vectors [B, 3] into the torso frame (R^T v)."""
        R = quat_to_rot(qpos[:, 3:7])  # body -> world
        return torch.einsum("bji,bj->bi", R, vectors)

    def observe(self, physics):
        qpos, qvel = physics.qpos, physics.qvel
        observation = torch.cat(
            [
                qpos[:, 2:3],
                qpos[:, 7:] - self.nominal_joint_positions[None],
                qvel[:, 6:],
                self._local(qpos, qvel[:, :3]),
                qvel[:, 3:6],  # free-joint angular velocity is body-local
                self._local(qpos, self.down.expand(qpos.shape[0], 3)),
                physics.ctrl,
            ],
            dim=-1,
        )
        observation = torch.nan_to_num(observation, nan=0.0, posinf=0.0, neginf=0.0)
        return torch.clamp(observation, -100.0, 100.0)

    def transition(self, physics, action, generator):
        ctrl = self.nominal_joint_positions[None] + action * self.action_scaling_factor
        qvel_in = physics.qvel
        if self.perturbation_chance > 0.0:
            kicked = draw(generator, torch.rand, (self.nr_envs,), device=self.device) < self.perturbation_chance
            kick = self.perturbation_velocity * draw(generator, torch.randn, (self.nr_envs, 2), device=self.device)
            qvel_in = qvel_in.clone()
            qvel_in[:, :2] += torch.where(kicked[:, None], kick, 0.0)
        qpos, qvel = engine.step(self.model, physics.qpos, qvel_in, ctrl, nr_substeps=self.nr_substeps)

        local_linear_velocity = self._local(qpos, qvel[:, :3])
        xy_velocity_difference_norm = torch.sum(
            torch.square(self.target_local_velocity[None] - local_linear_velocity[:, :2]), dim=-1
        )
        tracking_reward = torch.exp(-xy_velocity_difference_norm / 0.25)
        reward = torch.clamp(
            torch.nan_to_num(tracking_reward, nan=0.0, posinf=0.0, neginf=0.0), -10.0, 10.0
        )
        terminated = (qpos[:, 2] < 0.2) | (qpos[:, 2] > 1.0)
        info = {
            "env_info/reward_xy_vel_cmd": tracking_reward,
            "env_info/xy_vel_diff_norm": xy_velocity_difference_norm,
        }
        return AntPhysics(qpos=qpos, qvel=qvel, ctrl=ctrl), reward, terminated, info

    def info_spec(self):
        zeros = torch.zeros(self.nr_envs, device=self.device)
        return {"env_info/reward_xy_vel_cmd": zeros, "env_info/xy_vel_diff_norm": zeros}
