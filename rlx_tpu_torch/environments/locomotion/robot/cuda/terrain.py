"""Terrain functions: the plane and per-env diverse heightfields (the JAX
package's ``robot/tpu/terrain.py``).

Each env carries a ``[n*n]`` height grid row in its internal state, and the
engine's penalty contacts query it (``physics.engine.Terrain``).  The
diverse generator: two axis-aligned sine waves of random frequency, uniform
per-cell roughness and two layers of random blocks, all scaled by the env's
curriculum coefficient, shifted so the lowest cell is at 0.
"""

import math

import torch

from rlx_tpu_torch.physics.engine import Terrain


class PlaneTerrain:
    """Flat ground at z=0; no per-env state."""

    # effectively unbounded: the plane has no grid edge, so the edge
    # teleport in LocomotionEnv.step never triggers
    half_extent_m = 1e9

    def __init__(self, env, cfg):
        self.env = env

    def init_state(self, nr_envs):
        return {}

    def sample(self, internal, draws, curriculum_coeff):
        return internal

    def engine_terrain(self, internal):
        return None

    def height_at(self, internal, x, y):
        """x, y [B, K] world meters -> ground height [B, K]."""
        return torch.zeros_like(x)

    def center_height(self, internal):
        return None  # zero; callers treat None as 0.0


class HFieldDiverseTerrain:
    def __init__(self, env, cfg):
        self.env = env
        self.n = int(cfg.get("grid_cells", 64))
        self.half_extent_m = float(cfg.get("half_extent_m", 4.0))
        self.wave_fn_min = cfg["wave_fn_min"]
        self.wave_fn_max = cfg["wave_fn_max"]
        self.wave_height_max = cfg["wave_height_max_per_m_factor"] * env.robot_dimensions_mean
        self.random_height_max = cfg["random_height_max_per_m_factor"] * env.robot_dimensions_mean
        self.block_probability = cfg["block_probability"]
        self.block_length_in_meters = cfg["block_length_in_meters"]
        self.block_height_max = cfg["block_height_max_per_m_factor"] * env.robot_dimensions_mean
        self.cells_per_m = self.n / (2.0 * self.half_extent_m)

    def init_state(self, nr_envs):
        return {"terrain_height": torch.zeros((nr_envs, self.n * self.n), device=self.env.device)}

    def sample(self, internal, draws, curriculum_coeff):
        """Fresh per-env heightfields; the [B] curriculum scales every
        amplitude."""
        B = curriculum_coeff.shape[0]
        n = self.n
        dev = curriculum_coeff.device
        wave_height = curriculum_coeff * draws.uniform((B,), 0.0, self.wave_height_max)
        random_height = curriculum_coeff * draws.uniform((B,), 0.0, self.random_height_max)
        block_height = curriculum_coeff * draws.uniform((B,), 0.0, self.block_height_max)

        I = torch.arange(n, dtype=torch.float32, device=dev)[:, None].expand(n, n)
        J = I.T
        f1 = draws.uniform((B, 1, 1), self.wave_fn_min, self.wave_fn_max)
        f2 = draws.uniform((B, 1, 1), self.wave_fn_min, self.wave_fn_max)
        wave = torch.sin(2 * math.pi * f1 * I[None] / n) + torch.sin(2 * math.pi * f2 * J[None] / n)
        hf = wave_height[:, None, None] * wave
        hf = hf + draws.uniform((B, n, n), -1.0, 1.0) * random_height[:, None, None]

        # blocks: a coarse Bernoulli grid upsampled by repetition, two
        # layers, the second transposed
        block_cells = max(int(self.block_length_in_meters * self.cells_per_m), 1)
        nb = max(n // block_cells, 1)
        blocks1 = draws.bernoulli(self.block_probability, (B, nb, nb))
        blocks2 = draws.bernoulli(self.block_probability, (B, nb, nb))

        def up(b):
            return b.repeat_interleave(block_cells, 1).repeat_interleave(block_cells, 2)[:, :n, :n]

        hf = hf + up(blocks1).to(torch.float32) * block_height[:, None, None]
        hf = hf + up(blocks2).to(torch.float32).transpose(1, 2) * block_height[:, None, None]
        # shift so the minimum is 0 (the MuJoCo hfield convention)
        hf = hf - hf.amin(dim=(1, 2), keepdim=True)
        internal = dict(internal)
        internal["terrain_height"] = hf.reshape(B, n * n)
        return internal

    def engine_terrain(self, internal):
        return Terrain(height=internal["terrain_height"].T, n=self.n, half_extent_m=self.half_extent_m)

    def height_at(self, internal, x, y):
        """x, y [B, K] -> heights [B, K] (nearest cell, clipped to the grid;
        rounding half to even, as ``jnp.round``)."""
        n = self.n
        ix = torch.clamp(torch.round(x * self.cells_per_m + n // 2).to(torch.int64), 0, n - 1)
        iy = torch.clamp(torch.round(y * self.cells_per_m + n // 2).to(torch.int64), 0, n - 1)
        return torch.gather(internal["terrain_height"], 1, iy * n + ix)

    def center_height(self, internal):
        n = self.n
        return internal["terrain_height"][:, (n // 2) * n + n // 2]


TERRAIN_FUNCTIONS = {
    "plane": PlaneTerrain,
    "hfield_diverse": HFieldDiverseTerrain,
}


def get_terrain_function(name, env, cfg):
    return TERRAIN_FUNCTIONS[name](env, cfg)
