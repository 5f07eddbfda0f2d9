"""Host environments behind a numpy<->torch edge, and the Gymnasium bridge.

A host env is stepped on the CPU: C++ (``native/batcher.py``), Gymnasium
(``HostGymEnv`` below), dm_control (``dmc/host_bridge.py``) or a socket
(``custom_interface/prototype/connection.py``).  The JAX package bridges
such an env into its one fused program with ordered ``io_callback``s; the
port is eager, so the bridge is a plain edge inside ``reset`` / ``step``:

- the action goes to the host with a blocking copy, the one
  synchronisation a step (as the callback is in JAX);
- the host writes the step's six results (observation, final observation,
  reward, terminated, truncated, episode statistics) into one staging
  buffer, pinned when the env's device is a card;
- one copy carries the buffer to the env's device (``non_blocking`` on a
  card), and the state's tensors are views into it.

Vectorization and auto-reset are the JAX package's: SAME-STEP auto-reset
(``observation`` is post-reset, ``final_observation`` pre-reset) and the
last finished episode's return and length in ``info``, so every algorithm
runs unchanged on a host env.  Gymnasium is imported only when a
``HostGymEnv`` is made, so a machine without it imports this module.
"""

import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch

from rlx_tpu_torch.environments.spaces import BoxSpace, DiscreteSpace

FIELDS = ("observation", "final_observation", "reward", "stats", "terminated", "truncated")
ALIGN = 16
TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.uint8): torch.uint8,
                np.dtype(np.bool_): torch.bool}


@dataclasses.dataclass
class HostEnvState:
    observation: torch.Tensor
    final_observation: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    info: Dict[str, Any]
    eval_mode: bool = False

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


class HostEdge:
    """The staging buffer between a host env and ``device``.

    ``host`` holds numpy views of the six fields, written by the host step;
    ``upload()`` returns the fields as tensors on ``device``.  The fields lie
    in one byte buffer, each at a 16-byte aligned offset, so one copy moves
    them all and each tensor is a contiguous view of that copy.

    Reuse of the pinned buffer on a card: the copy up is ``non_blocking``,
    so the host must not write the buffer again before the copy has read
    it.  On the step path that holds by order alone: the next step's
    action comes down with a blocking device-to-host copy on the same
    stream, enqueued after this step's host-to-device copy, so when the
    action reaches the host the earlier copy has finished.  ``host_views()``
    also waits on an event recorded after the copy, which covers a reset
    that follows a step with no action in between (and returns at once on
    the step path).

    On the CPU ``.to("cpu")`` of a tensor returns the tensor itself, so the
    copy up is a ``clone()``: a state's tensors never alias the buffer the
    next step writes.
    """

    def __init__(self, nr_envs, obs_shape, obs_dtype, device):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        obs_shape = (nr_envs,) + tuple(obs_shape)
        specs = {
            "observation": (obs_shape, np.dtype(obs_dtype)),
            "final_observation": (obs_shape, np.dtype(obs_dtype)),
            "reward": ((nr_envs,), np.dtype(np.float32)),
            "stats": ((nr_envs, 2), np.dtype(np.float32)),
            "terminated": ((nr_envs,), np.dtype(np.bool_)),
            "truncated": ((nr_envs,), np.dtype(np.bool_)),
        }
        self.layout, offset = {}, 0
        for name in FIELDS:
            shape, dtype = specs[name]
            nbytes = int(np.prod(shape)) * dtype.itemsize
            self.layout[name] = (offset, nbytes, shape, dtype)
            offset += -(-nbytes // ALIGN) * ALIGN
        self.staging = torch.zeros(offset, dtype=torch.uint8, pin_memory=self.on_card)
        buffer = self.staging.numpy()
        self.host = {name: buffer[o:o + n].view(dtype).reshape(shape)
                     for name, (o, n, shape, dtype) in self.layout.items()}
        self._uploaded = torch.cuda.Event() if self.on_card else None

    def host_views(self):
        """The numpy views of the staging buffer, once no copy up still reads it."""
        if self.on_card:
            self._uploaded.synchronize()
        return self.host

    def action_to_host(self, action):
        """The action as a numpy array (a blocking copy from a card)."""
        if isinstance(action, torch.Tensor):
            return action.detach().to("cpu").numpy()
        return np.asarray(action)

    def upload(self):
        """The six fields as tensors on ``device``: views of one copy."""
        if self.on_card:
            data = self.staging.to(self.device, non_blocking=True)
            self._uploaded.record()
        else:
            data = self.staging.clone()
        return {name: data[o:o + n].view(TORCH_DTYPES[dtype]).view(shape)
                for name, (o, n, shape, dtype) in self.layout.items()}


class HostEnv:
    """Base of the host envs: the device-env protocol over a host step.

    Subclasses set ``nr_envs``, ``horizon``, the single spaces, and call
    ``_init_edge``; they implement ``_host_reset_into(seed, observation)``
    and ``_host_step_into(actions, out)``, which write into the numpy arrays
    they are given (``out`` holds the six fields of ``FIELDS``).
    ``_host_reset`` / ``_host_step`` return fresh arrays instead, as the
    JAX package's host callbacks do.
    """

    def _init_edge(self, obs_shape, obs_dtype, device):
        self.device = torch.device(device)
        self.edge = HostEdge(self.nr_envs, obs_shape, obs_dtype, device)
        self.timings = None  # a dict to accumulate seconds a phase of the step into

    def _host_reset_into(self, seed, observation):
        raise NotImplementedError

    def _host_step_into(self, actions, out):
        raise NotImplementedError

    def _fresh(self):
        return {name: np.empty(shape, dtype) for name, (_, _, shape, dtype) in self.edge.layout.items()}

    def _host_reset(self, seed):
        out = self._fresh()
        self._host_reset_into(seed, out["observation"])
        return out["observation"]

    def _host_step(self, actions):
        out = self._fresh()
        self._host_step_into(np.asarray(actions), out)
        return tuple(out[name] for name in ("observation", "final_observation", "reward",
                                            "terminated", "truncated", "stats"))

    def reset(self, seed, eval_mode=False):
        self._host_reset_into(int(seed), self.edge.host_views()["observation"])
        observation = self.edge.upload()["observation"]
        zeros = torch.zeros(self.nr_envs, device=self.device)
        falses = torch.zeros(self.nr_envs, dtype=torch.bool, device=self.device)
        return HostEnvState(
            observation=observation, final_observation=observation, reward=zeros,
            terminated=falses, truncated=falses,
            info={"rollout/episode_return": zeros, "rollout/episode_length": zeros},
            eval_mode=eval_mode,
        )

    def step(self, state, action):
        t0 = time.perf_counter()
        actions = self.edge.action_to_host(action)
        t1 = time.perf_counter()
        self._host_step_into(actions, self.edge.host_views())
        t2 = time.perf_counter()
        out = self.edge.upload()
        if self.timings is not None:
            t3 = time.perf_counter()
            for phase, seconds in (("action_down", t1 - t0), ("host_step", t2 - t1), ("results_up", t3 - t2)):
                self.timings[phase] = self.timings.get(phase, 0.0) + seconds
        return state.replace(
            observation=out["observation"],
            final_observation=out["final_observation"],
            reward=out["reward"],
            terminated=out["terminated"],
            truncated=out["truncated"],
            info={"rollout/episode_return": out["stats"][:, 0],
                  "rollout/episode_length": out["stats"][:, 1]},
        )

    def close(self):
        pass


class HostGymEnv(HostEnv):
    """The device-env protocol over Gymnasium envs.

    ``vectorization="sync"`` steps the envs in a loop in this process, or
    with ``async_workers > 0`` on a thread pool that, like the reference's
    AsyncVectorEnvWithSkipping, may SKIP the slowest ``async_skip_percentage``
    of envs a step: a skipped env returns its previous observation with zero
    reward, and its in-flight step is collected before its next action is
    applied.  ``vectorization="process"`` runs one forkserver worker per env
    (``process_pool.py``) with the same skipping.
    """

    def __init__(self, env_id, nr_envs, seed=0, env_kwargs=None,
                 async_workers=0, async_skip_percentage=0.0, env_fns=None,
                 vectorization="sync", device="cpu", first_env=0):
        import gymnasium as gym

        # env i is reset with seed + first_env + i: a dp rank's envs are
        # rows first_env.. of the global batch, seeded as at dp = 1
        self.first_env = int(first_env)

        self.env_id = env_id
        self.nr_envs = nr_envs
        if env_fns is None:
            env_kwargs = env_kwargs or {}
            env_fns = [
                (lambda eid=env_id, kw=env_kwargs: gym.make(eid, **kw))
                for _ in range(nr_envs)
            ]
        self._env_fns = env_fns
        # "process" defers env construction to the workers; other modes own
        # in-process env objects
        self._vectorization = vectorization
        if vectorization == "process":
            self._envs = []
            self._probe_env = env_fns[0]()  # spaces/spec probe only
        else:
            self._envs = [fn() for fn in env_fns]
            self._probe_env = self._envs[0]
        self._proc_pool = None
        self._seed = seed
        self._episode_return = np.zeros(nr_envs)
        self._episode_length = np.zeros(nr_envs)
        self._last_stats = np.zeros((nr_envs, 2), dtype=np.float32)
        self._async_skip = async_skip_percentage
        self._pool = None
        self._pending = [None] * nr_envs
        self._last_obs = None
        if async_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=async_workers)

        env0 = self._probe_env
        obs_space = env0.observation_space
        act_space = env0.action_space
        # uint8 image observations stay uint8 across the edge (4x fewer
        # bytes); the networks turn them into floats on the device
        self._obs_dtype = np.uint8 if obs_space.dtype == np.uint8 else np.float32
        self.single_observation_space = BoxSpace(
            low=np.asarray(obs_space.low, np.float32),
            high=np.asarray(obs_space.high, np.float32),
            shape=obs_space.shape, device=device,
        )
        if hasattr(act_space, "n"):
            self.single_action_space = DiscreteSpace(act_space.n, device=device)
            self._discrete = True
        else:
            self.single_action_space = BoxSpace(
                low=np.asarray(act_space.low, np.float32),
                high=np.asarray(act_space.high, np.float32),
                shape=act_space.shape, device=device,
            )
            self._discrete = False

        spec_horizon = getattr(env0.spec, "max_episode_steps", None)
        self.horizon = int(spec_horizon or 1000)
        self._obs_shape = (nr_envs,) + tuple(obs_space.shape)
        self._init_edge(obs_space.shape, self._obs_dtype, device)

    def _ensure_proc_pool(self):
        if self._proc_pool is None:
            from rlx_tpu_torch.environments.gym.process_pool import ProcessEnvPool

            # the probe env's slot is owned by worker 0 from here on
            self._probe_env.close()
            self._proc_pool = ProcessEnvPool(
                self._env_fns, self.single_observation_space.shape,
                self._obs_dtype, self._async_skip,
            )

    # ------------------------------------------------------------- host side
    def _host_reset_into(self, seed, observation):
        seed = int(seed) + self.first_env
        self._episode_return[:] = 0.0
        self._episode_length[:] = 0.0
        self._last_stats[:] = 0.0
        if self._vectorization == "process":
            self._ensure_proc_pool()
            observation[:] = self._proc_pool.reset(seed)
        else:
            for i, env in enumerate(self._envs):
                obs, _ = env.reset(seed=int(seed) + i)
                observation[i] = obs
        self._last_obs = observation.copy()

    def _host_step_into(self, actions, out):
        if self._vectorization == "process":
            if self._discrete:
                actions = [int(a) for a in actions]
            obs, final, reward, terminated, truncated, stats = self._proc_pool.step(actions)
            done = terminated | truncated
            self._last_stats[done] = stats[done]
            out["observation"][:], out["final_observation"][:] = obs, final
            out["reward"][:], out["terminated"][:], out["truncated"][:] = reward, terminated, truncated
            out["stats"][:] = self._last_stats
            return
        if self._pool is not None:
            return self._host_step_async(actions, out)
        for i, env in enumerate(self._envs):
            action = actions[i]
            if self._discrete:
                action = int(action)
            obs, r, term, trunc, info = env.step(action)
            out["final_observation"][i] = obs
            out["reward"][i] = r
            out["terminated"][i] = term
            out["truncated"][i] = trunc
            self._episode_return[i] += r
            self._episode_length[i] += 1
            if term or trunc:
                # wrapper-level stats (raw return before clipping/life
                # splits, e.g. Atari EpisodeStatistics) win over the
                # bridge's accumulator
                self._last_stats[i] = (
                    info.get("episode_return", self._episode_return[i]),
                    info.get("episode_length", self._episode_length[i]),
                )
                self._episode_return[i] = 0.0
                self._episode_length[i] = 0.0
                obs, _ = env.reset()
            out["observation"][i] = obs
        out["stats"][:] = self._last_stats

    def _step_one(self, i, action):
        env = self._envs[i]
        if self._discrete:
            action = int(action)
        obs, r, term, trunc, info = env.step(action)
        final = obs
        self._episode_return[i] += r
        self._episode_length[i] += 1
        if term or trunc:
            self._last_stats[i] = (
                info.get("episode_return", self._episode_return[i]),
                info.get("episode_length", self._episode_length[i]),
            )
            self._episode_return[i] = 0.0
            self._episode_length[i] = 0.0
            obs, _ = env.reset()
        return np.asarray(obs, self._obs_dtype), np.asarray(final, self._obs_dtype), r, term, trunc

    def _host_step_async(self, actions, out):
        out["reward"][:] = 0.0
        out["terminated"][:] = False
        out["truncated"][:] = False

        # dispatch new steps only for envs whose previous step has landed
        for i in range(self.nr_envs):
            if self._pending[i] is None:
                self._pending[i] = self._pool.submit(self._step_one, i, actions[i])

        max_skipped = int(self.nr_envs * self._async_skip)
        while sum(not f.done() for f in self._pending) > max_skipped:
            time.sleep(0.0005)

        for i in range(self.nr_envs):
            future = self._pending[i]
            if future.done():
                obs, final, r, term, trunc = future.result()
                out["observation"][i], out["final_observation"][i] = obs, final
                out["reward"][i], out["terminated"][i], out["truncated"][i] = r, term, trunc
                self._pending[i] = None
            else:
                # skipped: dummy result, step keeps running in the background
                out["observation"][i] = self._last_obs[i]
                out["final_observation"][i] = self._last_obs[i]
        self._last_obs = out["observation"].copy()
        out["stats"][:] = self._last_stats

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        for env in self._envs:
            env.close()
        if self._proc_pool is not None:
            self._proc_pool.close()
