"""dm_control suite 'walker/walk', stepped on the host."""

from rlx_tpu_torch.environments.dmc.host_bridge import make_dmc_registration
from rlx_tpu_torch.environments.environment_manager import extract_environment_name_from_file, register_environment

get_config, create_train_and_eval_env, GeneralProperties = make_dmc_registration("walker", "walk")

NAME = extract_environment_name_from_file(__file__)
register_environment(NAME, get_config, create_train_and_eval_env, GeneralProperties)
