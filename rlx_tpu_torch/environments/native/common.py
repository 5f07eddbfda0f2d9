"""Registration helper for the native C++ env batchers: each task directory
(``native/<task>/host``) is one call, as ``gym/common.py`` is for Gymnasium."""

from rlx_tpu_torch.environments.types import (
    ActionSpaceType,
    DataInterfaceType,
    ObservationSpaceType,
    SimulationType,
)
from rlx_tpu_torch.utils.config_dict import ConfigDict

# the eval env's seed: disjoint from the train env's per-env seed + i
# streams at any nr_envs
EVAL_SEED_XOR = 0x5EED_0E7A


def make_native_registration(batch_class, task, discrete=False, nr_envs=8):
    def get_config(environment_name):
        return ConfigDict(
            name=environment_name,
            seed=1,
            nr_envs=nr_envs,
            nr_threads=0,  # 0 = half the host's hardware threads
            render=False,  # the JAX package's key; nothing reads it
        )

    def create_train_and_eval_env(config):
        env_config = config.environment
        train_env, eval_env = (
            batch_class(task, env_config.nr_envs, seed=seed + env_config.get("first_env", 0),
                        nr_threads=env_config.nr_threads, device=config.runner.device)
            for seed in (env_config.seed, env_config.seed ^ EVAL_SEED_XOR)
        )
        for env in (train_env, eval_env):
            env.general_properties = general_properties
        return train_env, eval_env

    class general_properties:  # noqa: N801 - instance-like class record
        action_space_type = ActionSpaceType.DISCRETE if discrete else ActionSpaceType.CONTINUOUS
        observation_space_type = ObservationSpaceType.FLAT_VALUES
        data_interface_type = DataInterfaceType.TORCH
        simulation_type = SimulationType.HOST

    return get_config, create_train_and_eval_env, general_properties
