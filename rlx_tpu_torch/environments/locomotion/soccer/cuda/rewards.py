"""The soccer reward: the default locomotion shaping plus three foot terms
(the JAX package's ``soccer/tpu/rewards.py``):

- feet_flat: penalize gravity's tilt in each foot frame;
- feet_phase: track the expected swing-foot height of the gait phase, a
  positive term that joins tracking inside the clipped sum;
- feet_yaw: penalize foot yaw away from the trunk's.

Logical feet come from the robot's foot groups (heel and toe spheres share
an ankle body), so a foot's orientation and height are its group's first
sphere's.
"""

import math

import torch

from rlx_tpu_torch.environments.locomotion.robot.cuda.environment import einsum
from rlx_tpu_torch.environments.locomotion.robot.cuda.rewards import DefaultReward


class SoccerReward(DefaultReward):
    def __init__(self, env, cfg):
        super().__init__(env, cfg)
        dt = env.dt
        self.feet_flat_coeff = cfg["feet_flat_coeff"] * dt
        self.feet_phase_coeff = cfg["feet_phase_coeff"] * dt
        self.feet_phase_swing_height = cfg["feet_phase_swing_height"]
        self.feet_phase_tracking_sigma = cfg["feet_phase_tracking_sigma"]
        self.feet_height_on_flat_ground = cfg["feet_height_on_flat_ground"]
        self.feet_yaw_coeff = cfg["feet_yaw_coeff"] * dt
        self.foot_reps = torch.as_tensor([g[0] for g in env.foot_groups], dtype=torch.long, device=env.device)
        self.gravity_world = torch.tensor([0.0, 0.0, -1.0], device=env.device)

    def extra_terms(self, internal, obsdata, action, info):
        env = self.env
        cc = internal["env_curriculum_coeff"]
        foot_rot = obsdata["feet_rotations"][:, self.foot_reps]       # [B, 2, 3, 3]
        foot_pos = obsdata["feet_positions"][:, self.foot_reps]       # [B, 2, 3]

        # feet flat: gravity in the foot frame stays vertical
        gravity_in_foot = einsum("bfji,j->bfi", foot_rot, self.gravity_world)
        feet_tilt = torch.sqrt(torch.sum(torch.square(gravity_in_foot[..., :2]), dim=-1) + 1e-12)
        feet_flat = cc * self.feet_flat_coeff * -torch.sum(feet_tilt, dim=1)

        # feet phase: a Bezier-blended expected foot height over the cycle
        foot_z_rel = (foot_pos[..., 2] - env.foot_radius) - self.feet_height_on_flat_ground
        phase = env.gait_manager.phase_for_reward(internal)           # [B, 2]
        x = (phase + math.pi) / (2.0 * math.pi)
        s1 = 2.0 * x
        b1 = s1 ** 3 + 3.0 * (s1 ** 2 * (1.0 - s1))
        stance = self.feet_phase_swing_height * b1
        s2 = 2.0 * x - 1.0
        b2 = s2 ** 3 + 3.0 * (s2 ** 2 * (1.0 - s2))
        swing = self.feet_phase_swing_height * (1.0 - b2)
        expected_z = torch.where(x <= 0.5, stance, swing)
        total_error = torch.sum(torch.square(foot_z_rel - expected_z), dim=1)
        feet_phase = cc * self.feet_phase_coeff * torch.exp(-total_error / self.feet_phase_tracking_sigma)

        # feet yaw: the foot's heading tracks the trunk's
        base_yaw = obsdata["imu_orientation_euler"][:, 2]
        foot_yaw = torch.atan2(foot_rot[..., 1, 0], foot_rot[..., 0, 0])
        yaw_err = torch.remainder(foot_yaw - base_yaw[:, None] + math.pi, 2.0 * math.pi) - math.pi
        feet_yaw = cc * self.feet_yaw_coeff * -torch.mean(torch.square(yaw_err), dim=1)

        info["reward/feet_flat"] = feet_flat
        info["reward/feet_phase"] = feet_phase
        info["reward/feet_yaw"] = feet_yaw
        return feet_phase, feet_flat + feet_yaw
