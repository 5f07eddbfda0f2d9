"""Adapter: brax-style playground envs -> the port's device-env protocol
(the JAX package's ``environments/playground/adapter.py``).

Re-covers the reference's playground integration
(`rl_x/environments/mujoco_playground/g1_joystick_flat_terrain/mjx/wrappers.py:26-79`):
the wrapped env (vmapped, episodic, auto-resetting, as
``mujoco_playground.wrapper.wrap_for_brax_training`` makes it) exposes
``reset(generator) -> State`` / ``step(state, action) -> State`` with
``obs = {"state", "privileged_state"}``, ``done``, ``metrics`` and
``info["truncation"]``, its tensors on the adapter's device; this adapter
presents it as a batched env of the port (``EnvState``'s fields +
asymmetric observation indices: the policy slice is the prefix of the
privileged vector, exactly as the reference relies on).  ``reset`` takes a
seed, as the port's device envs do, and hands the wrapped env a
``torch.Generator`` seeded with it.

mujoco_playground is a JAX/MJX program, which the port does not import:
the adapter is written against the protocol and tested with a stub env
(tests/test_torch_playground.py), and the registration raises.

Known parity note: like the reference, ``final_observation`` mirrors
``observation`` (the brax-style auto-reset hides the pre-reset obs), so
bootstrap-on-truncation uses the post-reset obs — the reference has the
same approximation (`wrappers.py:41-42`, next == actual_next).
"""

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from rlx_tpu_torch.environments.env import make_generator
from rlx_tpu_torch.environments.spaces import BoxSpace
from rlx_tpu_torch.environments.types import (
    ActionSpaceType,
    DataInterfaceType,
    ObservationSpaceType,
    SimulationType,
)


@dataclasses.dataclass
class PlaygroundState:
    env_state: Any
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


class GeneralProperties:
    action_space_type = ActionSpaceType.CONTINUOUS
    observation_space_type = ObservationSpaceType.FLAT_VALUES
    data_interface_type = DataInterfaceType.TORCH
    simulation_type = SimulationType.DEVICE


class PlaygroundAdapter:
    """Wraps a brax-training-wrapped playground env for the port's algorithms."""

    general_properties = GeneralProperties

    def __init__(self, env, nr_envs, horizon, action_center=None, action_scale=None, device="cuda"):
        self.env = env
        self.nr_envs = nr_envs
        self.horizon = horizon
        self.device = torch.device(device)

        obs_size = env.observation_size
        if isinstance(obs_size, dict):
            policy_dim = int(np.asarray(obs_size["state"]).reshape(-1)[0])
            critic_dim = int(np.asarray(obs_size["privileged_state"]).reshape(-1)[0])
            self._obs_key = "privileged_state"
        else:  # plain vector observations: symmetric actor/critic
            policy_dim = critic_dim = int(obs_size)
            self._obs_key = None

        action_dim = int(env.action_size)
        self.single_action_space = BoxSpace(
            low=-1.0, high=1.0, shape=(action_dim,), center=action_center, scale=action_scale,
            device=self.device,
        )
        self.single_observation_space = BoxSpace(
            low=-np.inf, high=np.inf, shape=(critic_dim,), device=self.device
        )
        # the policy observation is the PREFIX of the privileged vector
        # (reference `wrappers.py:22-24`)
        self.policy_observation_indices = np.arange(policy_dim)
        self.critic_observation_indices = np.arange(critic_dim)

    def _obs(self, env_state):
        obs = env_state.obs
        return obs[self._obs_key] if self._obs_key is not None else obs

    def reset(self, seed, eval_mode=False):
        generator = make_generator(seed, self.device)
        env_state = self.env.reset(generator)
        zeros = torch.zeros(self.nr_envs, device=self.device)
        falses = torch.zeros(self.nr_envs, dtype=torch.bool, device=self.device)
        obs = self._obs(env_state)
        info = {
            "rollout/episode_return": zeros,
            "rollout/episode_length": zeros,
            **{f"env_info/{k}": v for k, v in env_state.metrics.items()},
        }
        return PlaygroundState(
            env_state=env_state, observation=obs, final_observation=obs,
            reward=zeros, terminated=falses, truncated=falses,
            info=info,
            episode_store={"episode_return": zeros, "episode_length": zeros},
            generator=generator, eval_mode=eval_mode,
        )

    def step(self, state, action):
        action = torch.clamp(action, -1.0, 1.0)
        env_state = self.env.step(state.env_state, action)
        done = env_state.done.bool()
        truncated = env_state.info["truncation"].bool()
        terminated = done & ~truncated

        episode_return = state.episode_store["episode_return"] + env_state.reward
        episode_length = state.episode_store["episode_length"] + 1.0
        info = {
            "rollout/episode_return": torch.where(
                done, episode_return, state.info["rollout/episode_return"]
            ),
            "rollout/episode_length": torch.where(
                done, episode_length, state.info["rollout/episode_length"]
            ),
            **{f"env_info/{k}": v for k, v in env_state.metrics.items()},
        }
        obs = self._obs(env_state)
        return state.replace(
            env_state=env_state,
            observation=obs,
            final_observation=obs,  # see module docstring: reference parity
            reward=env_state.reward,
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
