"""Batched Pendulum on the device, dynamics-equivalent to Gymnasium
Pendulum-v1 and to the JAX package's ``classic.pendulum.tpu``.

Physics (classic torque-limited swing-up):
  theta_dot' = theta_dot + (3 g / (2 l) sin(theta) + 3 / (m l^2) u) dt
  reward     = -(angle_norm(theta)^2 + 0.1 theta_dot^2 + 0.001 u^2)
with g=10, m=1, l=1, dt=0.05, |u|<=2, |theta_dot|<=8, 200-step horizon,
no termination (truncation only, so the value bootstrap path is exercised).
"""

import math
from typing import NamedTuple

import torch

from rlx_tpu_torch.environments.env import DeviceEnv, draw
from rlx_tpu_torch.environments.spaces import BoxSpace


class PendulumPhysics(NamedTuple):
    theta: torch.Tensor
    theta_dot: torch.Tensor


class Pendulum(DeviceEnv):
    parallel_seeds = True
    g = 10.0
    m = 1.0
    l = 1.0
    dt = 0.05
    max_speed = 8.0
    max_torque = 2.0

    def __init__(self, nr_envs, horizon=200, device="cuda"):
        self.nr_envs = nr_envs
        self.horizon = horizon
        self.device = torch.device(device)
        self.single_observation_space = BoxSpace(
            low=[-1.0, -1.0, -self.max_speed], high=[1.0, 1.0, self.max_speed], shape=(3,),
            device=self.device,
        )
        self.single_action_space = BoxSpace(
            low=[-self.max_torque], high=[self.max_torque], shape=(1,), device=self.device,
        )

    def initial_physics(self, generator, eval_mode):
        uniform = lambda lo, hi: lo + (hi - lo) * draw(generator, torch.rand, (self.nr_envs,), device=self.device)
        return PendulumPhysics(theta=uniform(-math.pi, math.pi), theta_dot=uniform(-1.0, 1.0))

    def observe(self, physics):
        return torch.stack(
            [torch.cos(physics.theta), torch.sin(physics.theta), physics.theta_dot], dim=-1
        )

    def transition(self, physics, action, generator):
        torque = torch.clamp(action[..., 0], -self.max_torque, self.max_torque)
        theta, theta_dot = physics.theta, physics.theta_dot

        angle = ((theta + math.pi) % (2.0 * math.pi)) - math.pi
        cost = angle ** 2 + 0.1 * theta_dot ** 2 + 0.001 * torque ** 2

        new_theta_dot = theta_dot + (
            3.0 * self.g / (2.0 * self.l) * torch.sin(theta)
            + 3.0 / (self.m * self.l ** 2) * torque
        ) * self.dt
        new_theta_dot = torch.clamp(new_theta_dot, -self.max_speed, self.max_speed)
        new_theta = theta + new_theta_dot * self.dt

        terminated = torch.zeros(self.nr_envs, dtype=torch.bool, device=self.device)
        return PendulumPhysics(theta=new_theta, theta_dot=new_theta_dot), -cost, terminated, {}
