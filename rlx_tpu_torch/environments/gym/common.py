"""Registration helper for Gymnasium host environments: each task
directory (``gym/<family>/<task>/host``) is one call that wires the config,
the env factory and the properties for a Gymnasium env id."""

from rlx_tpu_torch.environments.gym.host_bridge import HostGymEnv
from rlx_tpu_torch.environments.types import (
    ActionSpaceType,
    DataInterfaceType,
    ObservationSpaceType,
    SimulationType,
)
from rlx_tpu_torch.utils.config_dict import ConfigDict


def make_gym_registration(env_id, discrete=False, nr_envs=8):
    def get_config(environment_name):
        return ConfigDict(
            name=environment_name,
            env_id=env_id,
            seed=1,
            nr_envs=nr_envs,
            vectorization="sync",  # sync | process (forkserver workers)
            async_workers=0,  # > 0: thread-pool stepping (sync mode)
            async_skip_percentage=0.0,  # fraction of slowest envs to skip
            render=False,  # the JAX package's key; nothing reads it
        )

    def create_train_and_eval_env(config):
        env_config, device = config.environment, config.runner.device
        train_env = HostGymEnv(env_config.env_id, env_config.nr_envs, seed=env_config.seed,
                               async_workers=env_config.async_workers,
                               async_skip_percentage=env_config.async_skip_percentage,
                               vectorization=env_config.vectorization, device=device,
                               first_env=env_config.get("first_env", 0))
        eval_env = HostGymEnv(env_config.env_id, env_config.nr_envs, seed=env_config.seed + 10_000,
                              device=device, first_env=env_config.get("first_env", 0))
        for env in (train_env, eval_env):
            env.general_properties = general_properties
        return train_env, eval_env

    class general_properties:  # noqa: N801 - instance-like class record
        action_space_type = ActionSpaceType.DISCRETE if discrete else ActionSpaceType.CONTINUOUS
        observation_space_type = ObservationSpaceType.FLAT_VALUES
        data_interface_type = DataInterfaceType.TORCH
        simulation_type = SimulationType.HOST

    return get_config, create_train_and_eval_env, general_properties
