"""Wrappers over device-resident environments, the JAX package's
``environments/wrappers.py``:

- ``ObservationWindowWrapper``: the observation is the last
  ``window_length`` inner observations, flattened; the window lives in the
  env state and starts afresh (the new observation repeated) at an
  auto-reset;
- ``ObservationMaskWrapper``: keeps only some observation channels (the
  velocity-masked Pendulum is its POMDP test);
- ``DomainRandomizationWrapper``: per-env Gaussian observation noise and a
  stochastic action delay (the previous action replayed with probability
  ``action_delay_chance``);
- ``MemoryActionsWrapper``: the action gains ``memory_dimension`` extra
  entries, clipped to +-``memory_clip``, which are appended to the next
  observation and zeroed at an auto-reset.

The autoreset contract of ``environments/env.py`` holds through every
wrapper: ``final_observation`` is built from the window or memory as it was
before the reset.  A wrapper's state keeps the inner env's physics under
``physics["inner"]``.  Where the JAX package draws from the env state's key,
the port draws from the env state's ``torch.Generator``; ``reset`` and
``step`` of the randomization wrapper also take the draws explicitly.
"""

import math

import torch

from rlx_tpu_torch.environments.spaces import BoxSpace


class _Wrapper:
    def __init__(self, env):
        self.env = env
        self.nr_envs = env.nr_envs
        self.horizon = env.horizon
        self.device = env.device
        self.single_observation_space = env.single_observation_space
        self.single_action_space = env.single_action_space
        self.general_properties = getattr(env, "general_properties", None)

    @property
    def parallel_seeds(self):
        """Parallel seeds run where the inner env runs them (no wrapper here
        draws, but the randomization one)."""
        return getattr(self.env, "parallel_seeds", False)

    def _unbounded_observations(self, size):
        return BoxSpace(low=-math.inf, high=math.inf, shape=(size,), device=self.device)

    def close(self):
        self.env.close()


class ObservationWindowWrapper(_Wrapper):
    def __init__(self, env, window_length):
        super().__init__(env)
        self.window_length = window_length
        self.obs_dim = math.prod(env.single_observation_space.shape)
        self.single_observation_space = self._unbounded_observations(window_length * self.obs_dim)

    def _flat(self, window):
        return window.reshape(self.nr_envs, -1)

    def _fresh(self, observation):
        return observation[:, None].repeat(1, self.window_length, 1)

    def reset(self, seed, eval_mode=False):
        inner = self.env.reset(seed, eval_mode)
        window = self._fresh(inner.observation)
        observation = self._flat(window)
        return inner.replace(physics={"inner": inner.physics, "window": window},
                             observation=observation, final_observation=observation)

    def step(self, state, action):
        inner = self.env.step(state.replace(physics=state.physics["inner"]), action)
        done = inner.terminated | inner.truncated
        previous = state.physics["window"][:, 1:]
        final_window = torch.cat([previous, inner.final_observation[:, None]], dim=1)
        shifted = torch.cat([previous, inner.observation[:, None]], dim=1)
        window = torch.where(done[:, None, None], self._fresh(inner.observation), shifted)
        return inner.replace(physics={"inner": inner.physics, "window": window},
                             observation=self._flat(window), final_observation=self._flat(final_window))


class ObservationMaskWrapper(_Wrapper):
    def __init__(self, env, keep_indices):
        super().__init__(env)
        self.keep_indices = torch.as_tensor(list(keep_indices), dtype=torch.long, device=self.device)
        self.single_observation_space = self._unbounded_observations(len(keep_indices))

    def _mask(self, state):
        return state.replace(observation=state.observation[:, self.keep_indices],
                             final_observation=state.final_observation[:, self.keep_indices])

    def reset(self, seed, eval_mode=False):
        return self._mask(self.env.reset(seed, eval_mode))

    def step(self, state, action):
        return self._mask(self.env.step(state, action))


class DomainRandomizationWrapper(_Wrapper):
    parallel_seeds = False   # its draws are not per seed yet (ROADMAP Queue A item 19c)

    def __init__(self, env, observation_noise_std=0.0, action_delay_chance=0.0):
        super().__init__(env)
        self.observation_noise_std = observation_noise_std
        self.action_delay_chance = action_delay_chance
        self._action_dim = math.prod(env.single_action_space.shape)

    def _noisy(self, observation, generator, noise):
        """``observation`` plus ``observation_noise_std`` times ``noise``
        (standard normal, drawn from ``generator`` unless given)."""
        if self.observation_noise_std <= 0.0:
            return observation
        if noise is None:
            noise = torch.randn(observation.shape, generator=generator, device=self.device)
        return observation + self.observation_noise_std * noise

    def reset(self, seed, eval_mode=False, noise=None):
        inner = self.env.reset(seed, eval_mode)
        last_action = torch.zeros(self.nr_envs, self._action_dim, device=self.device)
        return inner.replace(physics={"inner": inner.physics, "last_action": last_action},
                             observation=self._noisy(inner.observation, inner.generator, noise))

    def step(self, state, action, noise=None, delay_draw=None):
        """``delay_draw`` (``[nr_envs]`` uniform in [0, 1), drawn from the
        state's generator unless given) below ``action_delay_chance``
        replays the env's previous action."""
        last_action = state.physics["last_action"]
        if self.action_delay_chance > 0.0:
            if delay_draw is None:
                delay_draw = torch.rand(self.nr_envs, generator=state.generator, device=self.device)
            action = torch.where((delay_draw < self.action_delay_chance)[:, None], last_action, action)
        inner = self.env.step(state.replace(physics=state.physics["inner"]), action)
        return inner.replace(physics={"inner": inner.physics, "last_action": action},
                             observation=self._noisy(inner.observation, inner.generator, noise))


class MemoryActionsWrapper(_Wrapper):
    def __init__(self, env, memory_dimension, memory_clip=10.0):
        # memory_clip is the reference's memory_action_mean_clip: a wide
        # range keeps the written signal well above the ~1-std exploration
        # noise
        super().__init__(env)
        self.memory_dimension = memory_dimension
        self.memory_clip = float(memory_clip)
        self.obs_dim = math.prod(env.single_observation_space.shape)
        inner_space = env.single_action_space
        self.inner_action_dim = math.prod(inner_space.shape)
        bound = lambda x: torch.broadcast_to(x, inner_space.shape).reshape(-1)
        memory_bound = torch.full((memory_dimension,), self.memory_clip, device=self.device)
        self.single_action_space = BoxSpace(
            low=torch.cat([bound(inner_space.low), -memory_bound]),
            high=torch.cat([bound(inner_space.high), memory_bound]),
            shape=(self.inner_action_dim + memory_dimension,), device=self.device,
        )
        self.single_observation_space = self._unbounded_observations(self.obs_dim + memory_dimension)

    def reset(self, seed, eval_mode=False):
        inner = self.env.reset(seed, eval_mode)
        memory = torch.zeros(self.nr_envs, self.memory_dimension, device=self.device)
        observation = torch.cat([inner.observation, memory], dim=-1)
        return inner.replace(physics={"inner": inner.physics, "memory": memory},
                             observation=observation, final_observation=observation)

    def step(self, state, action):
        env_action = action[:, :self.inner_action_dim]
        memory = torch.clamp(action[:, self.inner_action_dim:], -self.memory_clip, self.memory_clip)
        inner = self.env.step(state.replace(physics=state.physics["inner"]), env_action)
        done = inner.terminated | inner.truncated
        next_memory = torch.where(done[:, None], 0.0, memory)
        return inner.replace(
            physics={"inner": inner.physics, "memory": next_memory},
            observation=torch.cat([inner.observation, next_memory], dim=-1),
            final_observation=torch.cat([inner.final_observation, memory], dim=-1),
        )
