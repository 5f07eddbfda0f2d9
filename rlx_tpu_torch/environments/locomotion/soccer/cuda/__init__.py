"""RoboCup soccer locomotion env (the JAX package's ``locomotion.soccer.tpu``)."""

from rlx_tpu_torch.environments.environment_manager import extract_environment_name_from_file, register_environment
from rlx_tpu_torch.environments.locomotion.soccer.cuda.create_env import create_train_and_eval_env
from rlx_tpu_torch.environments.locomotion.soccer.cuda.default_config import get_config
from rlx_tpu_torch.environments.locomotion.soccer.cuda.general_properties import GeneralProperties

SOCCER_LOCOMOTION_CUDA = extract_environment_name_from_file(__file__)
register_environment(SOCCER_LOCOMOTION_CUDA, get_config, create_train_and_eval_env, GeneralProperties)
