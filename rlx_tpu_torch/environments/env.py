"""Device-resident environment protocol.

``reset``/``step`` operate on ``[B, ...]`` tensors with ``torch.where``-masked
auto-reset.  Field meaning:

  observation        post-auto-reset observation (policy input)
  final_observation  pre-auto-reset observation (bootstrap value target)
  info               logging metrics, incl. rollout/*
  episode_store      running return/length accumulators

Randomness comes from one ``torch.Generator`` on the env's device, owned by
the env state.
"""

import dataclasses
from typing import Any, Dict

import torch


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

    def initial_physics(self, generator, eval_mode):
        raise NotImplementedError

    def observe(self, physics):
        raise NotImplementedError

    def transition(self, physics, action, generator):
        raise NotImplementedError

    def info_spec(self) -> Dict[str, torch.Tensor]:
        """Zero-initialized env_info/* metrics (batched)."""
        return {}

    def reset(self, seed, eval_mode=False):
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
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
