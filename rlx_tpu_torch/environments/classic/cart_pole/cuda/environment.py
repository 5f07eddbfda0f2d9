"""Batched CartPole on the device, dynamics-equivalent to Gymnasium
CartPole-v1 and to the JAX package's ``classic.cart_pole.tpu``.  Two
discrete actions (push left, push right).

Physics (Barto-Sutton cart-pole, Euler steps, dt=0.02):
  temp      = (F + m_p l thdot^2 sin th) / (m_c + m_p)
  thacc     = (g sin th - cos th temp) / (l (4/3 - m_p cos^2 th / (m_c+m_p)))
  xacc      = temp - m_p l thacc cos th / (m_c + m_p)
termination: |x| > 2.4 or |theta| > 12 deg; reward 1 per step; horizon 500;
reset draws every state variable from U(-0.05, 0.05).
"""

import math
from typing import NamedTuple

import torch

from rlx_tpu_torch.environments.env import DeviceEnv, draw
from rlx_tpu_torch.environments.spaces import BoxSpace, DiscreteSpace


class CartPolePhysics(NamedTuple):
    x: torch.Tensor
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor


class CartPole(DeviceEnv):
    parallel_seeds = True
    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    length = 0.5  # half the pole's length
    force_mag = 10.0
    dt = 0.02
    theta_threshold = 12.0 * 2.0 * math.pi / 360.0
    x_threshold = 2.4

    def __init__(self, nr_envs, horizon=500, device="cuda"):
        self.nr_envs = nr_envs
        self.horizon = horizon
        self.device = torch.device(device)
        high = [4.8, math.inf, 0.42, math.inf]
        self.single_observation_space = BoxSpace(low=[-h for h in high], high=high, shape=(4,),
                                                 device=self.device)
        self.single_action_space = DiscreteSpace(2, device=self.device)

    def initial_physics(self, generator, eval_mode):
        values = draw(generator, torch.rand, (self.nr_envs, 4), device=self.device) * 0.1 - 0.05
        return CartPolePhysics(*values.unbind(1))

    def observe(self, physics):
        return torch.stack(list(physics), dim=-1)

    def transition(self, physics, action, generator):
        force = torch.where(action == 1, self.force_mag, -self.force_mag)
        x, x_dot, theta, theta_dot = physics
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length

        cos_t, sin_t = torch.cos(theta), torch.sin(theta)
        temp = (force + polemass_length * theta_dot ** 2 * sin_t) / total_mass
        theta_acc = (self.gravity * sin_t - cos_t * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * cos_t ** 2 / total_mass)
        )
        x_acc = temp - polemass_length * theta_acc * cos_t / total_mass

        x = x + self.dt * x_dot
        x_dot = x_dot + self.dt * x_acc
        theta = theta + self.dt * theta_dot
        theta_dot = theta_dot + self.dt * theta_acc

        terminated = (torch.abs(x) > self.x_threshold) | (torch.abs(theta) > self.theta_threshold)
        reward = torch.ones(self.nr_envs, device=self.device)
        return CartPolePhysics(x, x_dot, theta, theta_dot), reward, terminated, {}
