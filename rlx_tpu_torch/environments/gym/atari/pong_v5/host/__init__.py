"""ALE 'Pong-v5' host env (reference: rl_x/environments/gym/atari/pong_v5/)."""

from rlx_tpu_torch.environments.environment_manager import extract_environment_name_from_file, register_environment
from rlx_tpu_torch.environments.gym.atari.common import make_atari_registration

get_config, create_train_and_eval_env, GeneralProperties = make_atari_registration("Pong-v5")

NAME = extract_environment_name_from_file(__file__)
register_environment(NAME, get_config, create_train_and_eval_env, GeneralProperties)
