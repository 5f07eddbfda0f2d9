"""DeepMind Control Suite host environments (flat-observation adapter).

Wraps ``dm_control.suite`` directly: observations are flattened and
concatenated, actions pass through, episodes truncate at the suite's own
time limit (dm_control tasks end only through LAST timesteps: a discount
of 0 is a termination, else a truncation).  Same-step auto-reset and
episode statistics as every host env (``gym/host_bridge.py``).
"""

import os

import numpy as np

from rlx_tpu_torch.environments.gym.host_bridge import HostEnv
from rlx_tpu_torch.environments.spaces import BoxSpace
from rlx_tpu_torch.environments.types import (
    ActionSpaceType,
    DataInterfaceType,
    ObservationSpaceType,
    SimulationType,
)
from rlx_tpu_torch.utils.config_dict import ConfigDict


def _flatten_observation(obs_dict):
    return np.concatenate([np.asarray(v, np.float32).reshape(-1) for v in obs_dict.values()])


class DMCHostEnv(HostEnv):
    def __init__(self, domain, task, nr_envs, seed=0, device="cpu"):
        # dm_control needs a GL backend even without rendering; headless
        # machines lack X11
        os.environ.setdefault("MUJOCO_GL", "egl")
        from dm_control import suite

        self.nr_envs = nr_envs
        self._envs = [suite.load(domain, task, task_kwargs={"random": seed + i}) for i in range(nr_envs)]
        env0 = self._envs[0]
        self._obs_dim = _flatten_observation(env0.reset().observation).shape[0]
        spec = env0.action_spec()
        self.single_action_space = BoxSpace(low=np.asarray(spec.minimum, np.float32),
                                            high=np.asarray(spec.maximum, np.float32),
                                            shape=tuple(spec.shape), device=device)
        self.single_observation_space = BoxSpace(low=-np.inf, high=np.inf, shape=(self._obs_dim,), device=device)
        # control timestep * 1000 steps is the suite's default episode limit
        self.horizon = int(env0._step_limit) if hasattr(env0, "_step_limit") else 1000
        self._episode_return = np.zeros(nr_envs)
        self._episode_length = np.zeros(nr_envs)
        self._last_stats = np.zeros((nr_envs, 2), np.float32)
        self._init_edge((self._obs_dim,), np.float32, device)

    def _host_reset_into(self, _seed, observation):
        for i, env in enumerate(self._envs):
            observation[i] = _flatten_observation(env.reset().observation)
        self._episode_return[:] = 0
        self._episode_length[:] = 0
        self._last_stats[:] = 0

    def _host_step_into(self, actions, out):
        out["terminated"][:] = False
        out["truncated"][:] = False
        for i, env in enumerate(self._envs):
            ts = env.step(actions[i])
            obs = _flatten_observation(ts.observation)
            out["final_observation"][i] = obs
            out["reward"][i] = ts.reward or 0.0
            self._episode_return[i] += out["reward"][i]
            self._episode_length[i] += 1
            if ts.last():
                if ts.discount == 0.0:
                    out["terminated"][i] = True
                else:
                    out["truncated"][i] = True
                self._last_stats[i] = (self._episode_return[i], self._episode_length[i])
                self._episode_return[i] = 0.0
                self._episode_length[i] = 0.0
                obs = _flatten_observation(env.reset().observation)
            out["observation"][i] = obs
        out["stats"][:] = self._last_stats

    def close(self):
        for env in self._envs:
            env.close()


def make_dmc_registration(domain, task, nr_envs=4):
    """(get_config, create_train_and_eval_env, GeneralProperties) of one
    suite task; the eval env's seed is the train env's + 10,000."""
    def get_config(environment_name):
        return ConfigDict(name=environment_name, seed=1, nr_envs=nr_envs,
                          render=False)  # the JAX package's key; nothing reads it

    def create_train_and_eval_env(config):
        env_config = config.environment
        # a dp rank's envs (first_env, config.create_env) are seeded as at dp = 1
        train_env, eval_env = (DMCHostEnv(domain, task, env_config.nr_envs, seed=seed + env_config.get("first_env", 0),
                                          device=config.runner.device)
                               for seed in (env_config.seed, env_config.seed + 10_000))
        for env in (train_env, eval_env):
            env.general_properties = general_properties
        return train_env, eval_env

    class general_properties:  # noqa: N801 - instance-like class record
        action_space_type = ActionSpaceType.CONTINUOUS
        observation_space_type = ObservationSpaceType.FLAT_VALUES
        data_interface_type = DataInterfaceType.TORCH
        simulation_type = SimulationType.HOST

    return get_config, create_train_and_eval_env, general_properties
