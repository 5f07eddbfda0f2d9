"""TCP/JSON custom-interface env (reference:
rl_x/environments/custom_interface/prototype/)."""

from rlx_tpu_torch.environments.custom_interface.prototype.connection import SocketEnv
from rlx_tpu_torch.environments.environment_manager import extract_environment_name_from_file, register_environment
from rlx_tpu_torch.environments.types import (
    ActionSpaceType,
    DataInterfaceType,
    ObservationSpaceType,
    SimulationType,
)
from rlx_tpu_torch.utils.config_dict import ConfigDict


def get_config(environment_name):
    return ConfigDict(
        name=environment_name,
        seed=1,
        nr_envs=1,
        ip="127.0.0.1",
        port=11111,
        horizon=1000,
        render=False,  # the JAX package's key; nothing reads it
    )


def create_train_and_eval_env(config):
    env_config = config.environment
    env = SocketEnv(env_config.ip, env_config.port, horizon=env_config.horizon, device=config.runner.device)
    env.general_properties = GeneralProperties
    return env, env


class GeneralProperties:
    action_space_type = ActionSpaceType.CONTINUOUS
    observation_space_type = ObservationSpaceType.FLAT_VALUES
    data_interface_type = DataInterfaceType.TORCH
    simulation_type = SimulationType.HOST


NAME = extract_environment_name_from_file(__file__)
register_environment(NAME, get_config, create_train_and_eval_env, GeneralProperties)
