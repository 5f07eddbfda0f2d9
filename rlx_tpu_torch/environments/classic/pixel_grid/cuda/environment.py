"""PixelGrid: an image-observation grid world on the device, the JAX
package's ``classic.pixel_grid.tpu``.

The agent moves on an 8 x 8 grid (up, down, left, right; clipped at the
edges) and must reach a static goal: +1 and the episode terminates, -0.01
for every other step.  The observation is the grid rendered as one
``[84, 84, 1]`` float32 image in 0..255: goal cell mid-gray (128), agent
cell bright (255; written after the goal, so an agent on the goal shows
255), each cell replicated to 10 x 10 pixels and the 80 x 80 picture padded
with zeros to 84 x 84 at the bottom and right, NatureCNN's input size.
Every draw comes from the env state's ``torch.Generator`` (with parallel
seeds, each seed's envs from that seed's, through ``env.draw``).
"""

from typing import NamedTuple

import torch

from rlx_tpu_torch.environments.env import DeviceEnv, draw
from rlx_tpu_torch.environments.spaces import BoxSpace, DiscreteSpace

GRID_SIZE = 8
IMAGE_SIZE = 84
CELL = IMAGE_SIZE // GRID_SIZE   # pixels a cell, on each axis
GOAL_VALUE, AGENT_VALUE = 128, 255
# the row, column step of each action: up, down, left, right
MOVES = ((-1, 0), (1, 0), (0, -1), (0, 1))


class GridPhysics(NamedTuple):
    agent: torch.Tensor   # [B, 2] int64 (row, column)
    goal: torch.Tensor    # [B, 2] int64


def render_frame(agent, goal, dtype):
    """``[B, 84, 84]`` frames of ``dtype``: the goal cell 128, then the agent
    cell 255, replicated to ``CELL`` x ``CELL`` pixels, zero-padded from 80 to
    84 at the bottom and right."""
    B = agent.shape[0]
    rows = torch.arange(B, device=agent.device)
    grid = torch.zeros(B, GRID_SIZE, GRID_SIZE, dtype=dtype, device=agent.device)
    grid[rows, goal[:, 0], goal[:, 1]] = GOAL_VALUE
    grid[rows, agent[:, 0], agent[:, 1]] = AGENT_VALUE
    frame = torch.zeros(B, IMAGE_SIZE, IMAGE_SIZE, dtype=dtype, device=agent.device)
    side = GRID_SIZE * CELL
    frame[:, :side, :side] = grid.repeat_interleave(CELL, dim=1).repeat_interleave(CELL, dim=2)
    return frame


def cells(shape, generator, device):
    """Grid indices uniform in [0, GRID_SIZE), ``shape``."""
    return torch.randint(0, GRID_SIZE, shape, generator=generator, device=device)


def spawn(generator, nr_envs, device):
    """(agent, goal) uniform on the grid, ``[B, 2]`` each; a goal drawn on the
    agent's cell moves one row down, wrapping.  With parallel seeds each
    seed's rows come from its generator (``env.draw``)."""
    agent = draw(generator, cells, (nr_envs, 2), device=device)
    goal = draw(generator, cells, (nr_envs, 2), device=device)
    same = (agent == goal).all(dim=-1)
    goal[:, 0] = torch.where(same, (goal[:, 0] + 1) % GRID_SIZE, goal[:, 0])
    return agent, goal


def move(agent, action):
    """The agent's cell after ``action``, clipped to the grid."""
    moves = torch.tensor(MOVES, device=agent.device)
    return torch.clamp(agent + moves[action.long()], 0, GRID_SIZE - 1)


class PixelGrid(DeviceEnv):
    parallel_seeds = True
    grid_size = GRID_SIZE
    image_size = IMAGE_SIZE

    def __init__(self, nr_envs, horizon=64, device="cuda"):
        self.nr_envs = nr_envs
        self.horizon = horizon
        self.device = torch.device(device)
        self.single_observation_space = BoxSpace(low=0.0, high=255.0, shape=(IMAGE_SIZE, IMAGE_SIZE, 1),
                                                 device=self.device)
        self.single_action_space = DiscreteSpace(len(MOVES), device=self.device)

    def initial_physics(self, generator, eval_mode):
        return GridPhysics(*spawn(generator, self.nr_envs, self.device))

    def observe(self, physics):
        return render_frame(physics.agent, physics.goal, torch.float32)[..., None]

    def transition(self, physics, action, generator):
        agent = move(physics.agent, action)
        reached = (agent == physics.goal).all(dim=-1)
        reward = torch.where(reached, 1.0, -0.01)
        return GridPhysics(agent, physics.goal), reward, reached, {}
