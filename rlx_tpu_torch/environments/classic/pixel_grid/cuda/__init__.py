"""``classic.pixel_grid.cuda``: the image-observation grid world (the JAX
package's ``classic.pixel_grid.tpu``, with the same config keys)."""

from rlx_tpu_torch.environments.classic.pixel_grid.cuda.environment import PixelGrid
from rlx_tpu_torch.environments.environment_manager import extract_environment_name_from_file, register_environment
from rlx_tpu_torch.environments.types import (
    ActionSpaceType, DataInterfaceType, ObservationSpaceType, SimulationType,
)
from rlx_tpu_torch.utils.config_dict import ConfigDict


def get_config(environment_name):
    # render: accepted for the JAX package's command lines, read by nothing
    # (rendering is not ported)
    return ConfigDict(name=environment_name, seed=1, nr_envs=8, horizon=64, render=False)


def create_train_and_eval_env(config):
    e = config.environment
    train_env = PixelGrid(e.nr_envs, e.horizon, device=config.runner.device)
    eval_env = PixelGrid(e.nr_envs, e.horizon, device=config.runner.device)
    for env in (train_env, eval_env):
        env.general_properties = GeneralProperties
    return train_env, eval_env


class GeneralProperties:
    action_space_type = ActionSpaceType.DISCRETE
    observation_space_type = ObservationSpaceType.IMAGES
    data_interface_type = DataInterfaceType.TORCH
    simulation_type = SimulationType.DEVICE


PIXEL_GRID_CUDA = extract_environment_name_from_file(__file__)
register_environment(PIXEL_GRID_CUDA, get_config, create_train_and_eval_env, GeneralProperties)
