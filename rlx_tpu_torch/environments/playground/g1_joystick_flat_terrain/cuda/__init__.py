"""mujoco_playground G1JoystickFlatTerrain via the PlaygroundAdapter
(the JAX package's ``playground.g1_joystick_flat_terrain.tpu``; reference:
rl_x/environments/mujoco_playground/g1_joystick_flat_terrain/mjx/).

Registration and config work as in the JAX package, with its keys.  Env
CREATION raises ``ImportError`` whether or not mujoco_playground is
installed: the env is a JAX/MJX program, which the port does not import,
and it has no torch counterpart yet (the adapter itself is stub-tested in
tests/test_torch_playground.py).
"""

from rlx_tpu_torch.environments.environment_manager import extract_environment_name_from_file, register_environment
from rlx_tpu_torch.environments.playground.adapter import GeneralProperties
from rlx_tpu_torch.utils.config_dict import ConfigDict


def get_config(environment_name):
    return ConfigDict(
        name=environment_name,
        type="G1JoystickFlatTerrain",
        seed=1,
        nr_envs=4096,
        use_domain_randomization=False,
        render=False,
        copy_train_env_for_eval=True,
    )


def create_train_and_eval_env(config):
    raise ImportError(
        f"{config.environment.name}: mujoco_playground's {config.environment.type} is a JAX/MJX program with no "
        "torch counterpart yet, and the port does not import JAX; the adapter "
        "(rlx_tpu_torch/environments/playground/adapter.py) takes a brax-style env whose state holds torch tensors."
    )


NAME = extract_environment_name_from_file(__file__)
register_environment(NAME, get_config, create_train_and_eval_env, GeneralProperties)
