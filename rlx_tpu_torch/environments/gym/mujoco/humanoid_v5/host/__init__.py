"""Gymnasium host env 'Humanoid-v5'."""

from rlx_tpu_torch.environments.environment_manager import extract_environment_name_from_file, register_environment
from rlx_tpu_torch.environments.gym.common import make_gym_registration

get_config, create_train_and_eval_env, GeneralProperties = make_gym_registration("Humanoid-v5", discrete=False)

NAME = extract_environment_name_from_file(__file__)
register_environment(NAME, get_config, create_train_and_eval_env, GeneralProperties)
