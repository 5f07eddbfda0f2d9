"""Native C++ vectorized classic-control 'cart_pole', stepped on the host."""

from rlx_tpu_torch.environments.environment_manager import extract_environment_name_from_file, register_environment
from rlx_tpu_torch.environments.native.batcher import NativeEnvBatch
from rlx_tpu_torch.environments.native.common import make_native_registration

get_config, create_train_and_eval_env, GeneralProperties = make_native_registration(
    NativeEnvBatch, "cart_pole", discrete=True
)

NAME = extract_environment_name_from_file(__file__)
register_environment(NAME, get_config, create_train_and_eval_env, GeneralProperties)
