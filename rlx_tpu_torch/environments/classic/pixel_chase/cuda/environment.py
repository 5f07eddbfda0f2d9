"""PixelChase: an image env whose goal drifts, so a policy needs several
frames to see where it goes; the JAX package's ``classic.pixel_chase.tpu``.

The 8 x 8 grid, moves, rewards and rendering are PixelGrid's
(``pixel_grid/cuda/environment.py``).  The goal moves one cell every
``goal_period`` steps in a per-episode random direction and wraps at the
edges, while the agent is clipped; a catch (+1) ends the episode, every
other step costs -0.01.  At ``goal_period=1`` the goal moves at the agent's
speed, so chasing the goal's current cell never closes the distance: the
agent has to intercept it, and the drift direction shows only across two
or more frames.

The frame stack is kept as uint8 ``[B, 84, 84, frame_stack]``, the newest
frame last; a fresh episode repeats its first frame.  ``observe`` returns it
as float32 in 0..255.  Every draw comes from the env state's
``torch.Generator`` (with parallel seeds, each seed's envs from that
seed's, through ``env.draw``).
"""

from typing import NamedTuple

import torch

from rlx_tpu_torch.environments.classic.pixel_grid.cuda.environment import (
    GRID_SIZE, IMAGE_SIZE, MOVES, move, render_frame, spawn,
)
from rlx_tpu_torch.environments.env import DeviceEnv, draw
from rlx_tpu_torch.environments.spaces import BoxSpace, DiscreteSpace


class ChasePhysics(NamedTuple):
    agent: torch.Tensor      # [B, 2] int64 (row, column)
    goal: torch.Tensor       # [B, 2] int64
    direction: torch.Tensor  # [B] int64 index into MOVES
    step: torch.Tensor       # [B] int64 steps since the episode's start
    frames: torch.Tensor     # [B, 84, 84, frame_stack] uint8, the newest last


class PixelChase(DeviceEnv):
    parallel_seeds = True
    grid_size = GRID_SIZE
    image_size = IMAGE_SIZE

    def __init__(self, nr_envs, horizon=64, frame_stack=4, goal_period=1, device="cuda"):
        self.nr_envs = nr_envs
        self.horizon = horizon
        self.frame_stack = frame_stack
        self.goal_period = goal_period
        self.device = torch.device(device)
        self.single_observation_space = BoxSpace(low=0.0, high=255.0,
                                                 shape=(IMAGE_SIZE, IMAGE_SIZE, frame_stack), device=self.device)
        self.single_action_space = DiscreteSpace(len(MOVES), device=self.device)

    def initial_physics(self, generator, eval_mode):
        agent, goal = spawn(generator, self.nr_envs, self.device)
        direction = draw(generator, lambda shape, **kw: torch.randint(0, len(MOVES), shape, **kw), (self.nr_envs,),
                         device=self.device)
        frame = render_frame(agent, goal, torch.uint8)
        frames = frame[..., None].repeat(1, 1, 1, self.frame_stack)
        step = torch.zeros(self.nr_envs, dtype=torch.long, device=self.device)
        return ChasePhysics(agent, goal, direction, step, frames)

    def observe(self, physics):
        return physics.frames.to(torch.float32)

    def transition(self, physics, action, generator):
        agent = move(physics.agent, action)
        step = physics.step + 1
        goal_moves = (step % self.goal_period == 0)[:, None]
        drift = torch.tensor(MOVES, device=self.device)[physics.direction]
        goal = torch.where(goal_moves, (physics.goal + drift) % GRID_SIZE, physics.goal)
        caught = (agent == goal).all(dim=-1)
        reward = torch.where(caught, 1.0, -0.01)
        frames = torch.cat([physics.frames[..., 1:], render_frame(agent, goal, torch.uint8)[..., None]], dim=-1)
        return ChasePhysics(agent, goal, physics.direction, step, frames), reward, caught, {}
