from rlx_tpu_torch.algorithms.algorithm_manager import extract_algorithm_name_from_file, register_algorithm
from rlx_tpu_torch.algorithms.td3.cuda.default_config import get_config
from rlx_tpu_torch.algorithms.td3.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.td3.cuda.td3 import TD3

TD3_CUDA = extract_algorithm_name_from_file(__file__)
register_algorithm(TD3_CUDA, get_config, lambda: TD3, GeneralProperties)
