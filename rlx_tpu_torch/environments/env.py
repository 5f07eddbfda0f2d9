"""Device-resident environment protocol.

``reset``/``step`` operate on ``[B, ...]`` tensors with ``torch.where``-masked
auto-reset.  Field meaning:

  observation        post-auto-reset observation (policy input)
  final_observation  pre-auto-reset observation (bootstrap value target)
  info               logging metrics, incl. rollout/*
  episode_store      running return/length accumulators

Randomness comes from one ``torch.Generator`` on the env's device, owned by
the env state.  With parallel seeds (``algorithms/parallel_seeds.py``) the
env holds ``S * N`` envs, ``reset`` takes one seed per seed and the state
owns a list of S generators; an env whose draws all go through ``draw``
sets ``parallel_seeds = True``, and ``draw`` takes each seed's ``N`` rows
from that seed's generator, as its one-seed env of ``N`` envs would.  Such
an env also runs under the dp mesh (``parallel/mesh.py``): with
``dp_rows = (first, total)`` set (``shard_env``) it holds rows ``first ..
first + nr_envs`` of ``total`` envs and draws each from the global draw
(``RankRows``), as the dp = 1 env would.

An env whose ``step`` a CUDA graph can capture sets ``capturable = True``
(``algorithms/training_program.py``): every draw comes from the state's
generator, the auto-reset is the masked select below, nothing reads a
device value back to the host and nothing makes a tensor from host data
(the Ant, CartPole and Pendulum on ``DeviceEnv``; the robot and soccer envs,
``LocomotionEnv``, with their own masked auto-reset).
"""

import dataclasses
from typing import Any, Dict

import torch
import torch.utils._pytree as pytree

from rlx_tpu_torch.parallel.mesh import RankRows


@dataclasses.dataclass
class EnvState:
    physics: Any
    observation: torch.Tensor
    final_observation: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    info: Dict[str, torch.Tensor]
    episode_store: Dict[str, torch.Tensor]
    generator: torch.Generator
    eval_mode: bool = False

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    # the fields that hold tensors (nested in NamedTuples and dicts)
    TENSOR_FIELDS = ("physics", "observation", "final_observation", "reward", "terminated", "truncated", "info",
                     "episode_store")

    def generators(self):
        """The ``torch.Generator``s the state draws from: its one, or each
        seed's with parallel seeds (a captured learning iteration registers
        them with its CUDA graph)."""
        return [self.generator] if isinstance(self.generator, torch.Generator) else list(self.generator)

    def _leaves(self):
        return pytree.tree_flatten([getattr(self, f) for f in self.TENSOR_FIELDS])

    def map_tensors(self, fn):
        """A copy with ``fn`` applied to each of the state's tensors (the
        generators and ``eval_mode`` kept)."""
        leaves, spec = self._leaves()
        fields = pytree.tree_unflatten([fn(x) if isinstance(x, torch.Tensor) else x for x in leaves], spec)
        return self.replace(**dict(zip(self.TENSOR_FIELDS, fields)))

    def copy_(self, other):
        """In place: each of the state's tensors takes the value of the same
        tensor of ``other``, a state of the same structure, shapes and types
        (the end of a captured learning iteration).  A tensor of ``other``
        that is one of this state's is read before any is written."""
        (mine, spec), (theirs, other_spec) = self._leaves(), other._leaves()
        if spec != other_spec:
            raise ValueError("the env states differ in structure")
        written = {x.data_ptr() for x in mine if isinstance(x, torch.Tensor)}
        pairs = []
        for dst, src in zip(mine, theirs):
            if not isinstance(dst, torch.Tensor):
                continue
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"an env state tensor {tuple(src.shape)} {src.dtype} cannot take the place "
                                 f"of {tuple(dst.shape)} {dst.dtype}")
            pairs.append((dst, src.clone() if src is not dst and src.data_ptr() in written else src))
        for dst, src in pairs:
            if src is not dst:
                dst.copy_(src)
        return self


def draw(generator, sample, shape, **kwargs):
    """``sample(shape, generator=..., **kwargs)`` with ``shape[0]`` the env
    axis; for a list of S generators (parallel seeds) each takes its
    ``shape[0] // S`` rows, concatenated seed-major; for a dp rank's
    ``RankRows`` the rank's rows of the global draw."""
    if isinstance(generator, torch.Generator):
        return sample(shape, generator=generator, **kwargs)
    if isinstance(generator, RankRows):
        return generator.draw(sample, shape, **kwargs)
    rows = (shape[0] // len(generator),) + tuple(shape[1:])
    return torch.cat([sample(rows, generator=g, **kwargs) for g in generator])


def make_generator(seed, device):
    """A seeded generator, or for a list of seeds one per seed."""
    if isinstance(seed, (list, tuple)):
        return [torch.Generator(device=device).manual_seed(int(x)) for x in seed]
    return torch.Generator(device=device).manual_seed(int(seed))


def tree_where(pred, on_true, on_false):
    """Select per env between two NamedTuples of ``[B, ...]`` tensors."""

    def sel(a, b):
        p = pred.reshape(pred.shape + (1,) * (a.ndim - pred.ndim))
        return torch.where(p, a, b)

    return type(on_true)(*(sel(a, b) for a, b in zip(on_true, on_false)))


class DeviceEnv:
    """Base class for batched environments on one device.

    Subclasses implement:
      - ``initial_physics(generator, eval_mode) -> physics``   (NamedTuple of ``[B, ...]``)
      - ``observe(physics) -> obs``                             (``[B, obs]``)
      - ``transition(physics, action, generator) ->
            (physics, reward, terminated, info)``
    and set ``nr_envs``, ``horizon``, ``device``, ``single_observation_space``,
    ``single_action_space``.  The base class owns reset bookkeeping and the
    masked auto-reset.
    """

    nr_envs: int
    horizon: int
    device: torch.device
    parallel_seeds = False
    capturable = False

    def initial_physics(self, generator, eval_mode):
        raise NotImplementedError

    def observe(self, physics):
        raise NotImplementedError

    def transition(self, physics, action, generator):
        raise NotImplementedError

    def info_spec(self) -> Dict[str, torch.Tensor]:
        """Zero-initialized env_info/* metrics (batched)."""
        return {}

    dp_rows = None   # (first, total) of a dp rank's env rows (shard_env)

    def reset(self, seed, eval_mode=False):
        generator = make_generator(seed, self.device)
        if self.dp_rows is not None:
            generator = RankRows(generator, *self.dp_rows)
        physics = self.initial_physics(generator, eval_mode)
        observation = self.observe(physics)
        zeros = torch.zeros(self.nr_envs, device=self.device)
        falses = torch.zeros(self.nr_envs, dtype=torch.bool, device=self.device)
        info = {
            "rollout/episode_return": zeros,
            "rollout/episode_length": zeros,
            **self.info_spec(),
        }
        return EnvState(
            physics=physics,
            observation=observation,
            final_observation=observation,
            reward=zeros,
            terminated=falses,
            truncated=falses,
            info=info,
            episode_store={"episode_return": zeros, "episode_length": zeros},
            generator=generator,
            eval_mode=eval_mode,
        )

    def step(self, state, action):
        physics, reward, terminated, env_info = self.transition(
            state.physics, action, state.generator
        )
        observation = self.observe(physics)

        episode_length = state.episode_store["episode_length"] + 1.0
        episode_return = state.episode_store["episode_return"] + reward
        truncated = (episode_length >= self.horizon) & ~terminated
        done = terminated | truncated

        info = dict(state.info)
        info.update(env_info)
        info["rollout/episode_return"] = torch.where(done, episode_return, info["rollout/episode_return"])
        info["rollout/episode_length"] = torch.where(done, episode_length, info["rollout/episode_length"])

        # Masked auto-reset: fresh initial states for the whole batch,
        # selected per env by `done`.
        reset_physics = self.initial_physics(state.generator, state.eval_mode)
        new_physics = tree_where(done, reset_physics, physics)
        done_obs = done.reshape((-1,) + (1,) * (observation.ndim - 1))
        new_observation = torch.where(done_obs, self.observe(reset_physics), observation)

        return state.replace(
            physics=new_physics,
            observation=new_observation,
            final_observation=observation,
            reward=reward,
            terminated=terminated,
            truncated=truncated,
            info=info,
            episode_store={
                "episode_return": torch.where(done, 0.0, episode_return),
                "episode_length": torch.where(done, 0.0, episode_length),
            },
        )

    def close(self):
        pass


def shard_env(env, first, total):
    """Make ``env`` (and every env it wraps) hold rows ``first .. first +
    env.nr_envs`` of ``total`` dp-sharded envs."""
    while env is not None:
        env.dp_rows = (first, total)
        env = getattr(env, "env", None)
