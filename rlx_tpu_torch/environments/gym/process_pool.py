"""Process-based async env vectorization with slow-env skipping.

Cross-process equivalent of the reference's AsyncVectorEnvWithSkipping
(`rl_x/environments/gym/mujoco/humanoid_v4/async_vectorized_wrapper.py:10-90`),
re-built for the host bridge's env contract: one worker
process per env (forkserver, like the reference, to avoid fork/thread
interference), observations returned through POSIX shared memory (two
[nr_envs, *obs] buffers: post-reset ``obs`` and pre-reset ``final_obs``),
and SAME-STEP auto-reset with raw episode statistics handled inside the
worker so the parent's host step sees exactly the device-env protocol.  The module
imports numpy only (and the packages above it import nothing), so a worker
never pays for importing torch.

Skipping: after dispatch, the parent polls result pipes until at most
``skip_threshold`` envs are still running; those are SKIPPED this step
(previous observation, zero reward) and their in-flight result is consumed
on a later step before a new action is sent.
"""

import multiprocessing as mp
import pickle

import numpy as np

try:
    import cloudpickle
except ImportError:  # pragma: no cover
    cloudpickle = None


class _PickledFn:
    """Ship arbitrary env thunks (closures included) across forkserver."""

    def __init__(self, fn):
        self.blob = (cloudpickle or pickle).dumps(fn)

    def __call__(self):
        return pickle.loads(self.blob)()


def _worker(index, env_fn_blob, cmd_pipe, obs_name, final_name, obs_shape, obs_dtype):
    from multiprocessing import shared_memory

    env = env_fn_blob()
    obs_shm = shared_memory.SharedMemory(name=obs_name)
    final_shm = shared_memory.SharedMemory(name=final_name)
    obs_buf = np.ndarray(obs_shape, dtype=obs_dtype, buffer=obs_shm.buf)
    final_buf = np.ndarray(obs_shape, dtype=obs_dtype, buffer=final_shm.buf)

    episode_return = 0.0
    episode_length = 0
    try:
        while True:
            cmd, data = cmd_pipe.recv()
            if cmd == "reset":
                obs, _ = env.reset(seed=int(data))
                episode_return = 0.0
                episode_length = 0
                obs_buf[index] = obs
                final_buf[index] = obs
                cmd_pipe.send(("reset_done", None))
            elif cmd == "step":
                obs, reward, terminated, truncated, info = env.step(data)
                episode_return += float(reward)
                episode_length += 1
                final_buf[index] = obs
                stats = (0.0, 0.0)
                if terminated or truncated:
                    stats = (
                        float(info.get("episode_return", episode_return)),
                        float(info.get("episode_length", episode_length)),
                    )
                    episode_return = 0.0
                    episode_length = 0
                    obs, _ = env.reset()
                obs_buf[index] = obs
                cmd_pipe.send(("step_done", (float(reward), bool(terminated), bool(truncated), stats)))
            elif cmd == "close":
                break
    finally:
        env.close()
        obs_shm.close()
        final_shm.close()


class ProcessEnvPool:
    """One process per env + shared-memory observations + skipping."""

    def __init__(self, env_fns, obs_shape, obs_dtype, skip_percentage=0.0):
        from multiprocessing import shared_memory

        self.nr_envs = len(env_fns)
        self.obs_shape = (self.nr_envs,) + tuple(obs_shape)
        self.obs_dtype = np.dtype(obs_dtype)
        self.skip_threshold = int(self.nr_envs * skip_percentage)

        nbytes = int(np.prod(self.obs_shape)) * self.obs_dtype.itemsize
        self._obs_shm = shared_memory.SharedMemory(create=True, size=nbytes)
        self._final_shm = shared_memory.SharedMemory(create=True, size=nbytes)
        self.obs = np.ndarray(self.obs_shape, dtype=self.obs_dtype, buffer=self._obs_shm.buf)
        self.final_obs = np.ndarray(self.obs_shape, dtype=self.obs_dtype, buffer=self._final_shm.buf)

        ctx_name = "forkserver" if "forkserver" in mp.get_all_start_methods() else "spawn"
        ctx = mp.get_context(ctx_name)
        self._pipes = []
        self._procs = []
        self._pending = [False] * self.nr_envs  # step sent, result not consumed
        for i, fn in enumerate(env_fns):
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_worker,
                args=(i, _PickledFn(fn), child, self._obs_shm.name, self._final_shm.name,
                      self.obs_shape, self.obs_dtype),
                daemon=True,
            )
            proc.start()
            child.close()
            self._pipes.append(parent)
            self._procs.append(proc)

    def reset(self, seed):
        # drain any in-flight steps from a previous episode of use
        for i, pipe in enumerate(self._pipes):
            if self._pending[i]:
                pipe.recv()
                self._pending[i] = False
        for i, pipe in enumerate(self._pipes):
            pipe.send(("reset", int(seed) + i))
        for pipe in self._pipes:
            pipe.recv()
        return self.obs.copy()

    def step(self, actions):
        """-> (obs, final_obs, reward, terminated, truncated, stats [B, 2]).

        Skipped envs repeat their previous observation with zero reward;
        their in-flight transition is consumed on a later call.
        """
        reward = np.zeros(self.nr_envs, np.float32)
        terminated = np.zeros(self.nr_envs, bool)
        truncated = np.zeros(self.nr_envs, bool)
        stats = np.zeros((self.nr_envs, 2), np.float32)
        prev_obs = self.obs.copy()
        prev_final = self.final_obs.copy()

        for i, pipe in enumerate(self._pipes):
            if not self._pending[i]:
                pipe.send(("step", actions[i]))
                self._pending[i] = True

        collected = [False] * self.nr_envs
        while True:
            for i, pipe in enumerate(self._pipes):
                if collected[i] or not self._pending[i]:
                    continue
                if pipe.poll():
                    _, (r, term, trunc, st) = pipe.recv()
                    reward[i], terminated[i], truncated[i] = r, term, trunc
                    stats[i] = st
                    collected[i] = True
                    self._pending[i] = False
            still_running = sum(self._pending[i] and not collected[i] for i in range(self.nr_envs))
            if still_running <= self.skip_threshold:
                break

        obs = self.obs.copy()
        final = self.final_obs.copy()
        for i in range(self.nr_envs):
            if self._pending[i]:  # skipped: worker may write concurrently
                obs[i] = prev_obs[i]
                final[i] = prev_final[i]
        return obs, final, reward, terminated, truncated, stats

    def close(self):
        for i, pipe in enumerate(self._pipes):
            try:
                if self._pending[i]:
                    pipe.recv()
                pipe.send(("close", None))
            except (BrokenPipeError, EOFError):
                pass
        for proc in self._procs:
            proc.join(timeout=2)
            if proc.is_alive():
                proc.terminate()
        self._obs_shm.close()
        self._final_shm.close()
        try:
            self._obs_shm.unlink()
            self._final_shm.unlink()
        except FileNotFoundError:
            pass
