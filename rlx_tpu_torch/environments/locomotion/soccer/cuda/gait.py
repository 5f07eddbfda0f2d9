"""Sinusoidal gait-phase manager, batched over the env axis (the JAX
package's ``soccer/tpu/gait.py``).

Two anti-phase foot oscillators in the env's internal state, advancing by
``2 pi dt freq`` per control step.  The observation features and the phase
reward read the next step's phase (``phase + phase_dt``); a standing
command pins the reward phase to pi (both feet expected on the ground).
"""

import math

import torch


def wrap_to_pi(x):
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi


class GaitManager:
    STAND_PHASE = math.pi

    def __init__(self, env, cfg):
        self.env = env
        self.gait_period = cfg["gait_period"]
        self.width = cfg["gait_period_randomization_width"]
        self.mean_freq = 1.0 / self.gait_period
        self.canonical_phase = torch.tensor([0.0, -math.pi], device=env.device)

    def _canonical(self, nr_envs):
        return self.canonical_phase[None].repeat(nr_envs, 1)

    def init_state(self, nr_envs):
        freq = torch.full((nr_envs,), self.mean_freq, device=self.env.device)
        return {
            "gait_phase": self._canonical(nr_envs),
            "gait_freq": freq,
            "gait_phase_dt": (2.0 * math.pi * self.env.dt) * freq,
        }

    def episode_start(self, internal, mask, draws, eval_mode):
        """Masked per-episode resample of the phase offset and frequency,
        scaled by the curriculum; evaluation keeps the canonical gait."""
        B = mask.shape[0]
        cc = internal["env_curriculum_coeff"]
        phase0 = cc * draws.uniform((B,), -math.pi, math.pi)
        offsets = torch.stack([phase0, wrap_to_pi(phase0 + math.pi)], dim=1)
        low = self.mean_freq - cc * self.width
        high = self.mean_freq + cc * self.width
        freq = draws.uniform((B,), 0.0, 1.0) * (high - low) + low
        if eval_mode:
            offsets = self._canonical(B).to(offsets.dtype)
            freq = torch.full_like(freq, self.mean_freq)

        internal = dict(internal)
        internal["gait_phase"] = torch.where(mask[:, None], offsets, internal["gait_phase"])
        internal["gait_freq"] = torch.where(mask, freq, internal["gait_freq"])
        internal["gait_phase_dt"] = (2.0 * math.pi * self.env.dt) * internal["gait_freq"]
        return internal

    def phase_features(self, internal):
        """[B, 4] sin / cos of the next step's two foot phases."""
        phase_tp1 = wrap_to_pi(internal["gait_phase"] + internal["gait_phase_dt"][:, None])
        return torch.cat([torch.sin(phase_tp1), torch.cos(phase_tp1)], dim=-1)

    def phase_for_reward(self, internal):
        """[B, 2]; a standing command pins the stand phase (both feet down)."""
        phase_tp1 = wrap_to_pi(internal["gait_phase"] + internal["gait_phase_dt"][:, None])
        standing = torch.all(internal["goal_velocities"] == 0.0, dim=1)
        return torch.where(standing[:, None], self.STAND_PHASE, phase_tp1)

    def step(self, internal):
        internal = dict(internal)
        internal["gait_phase"] = wrap_to_pi(internal["gait_phase"] + internal["gait_phase_dt"][:, None])
        return internal
