from rlx_tpu_torch.algorithms.algorithm_manager import extract_algorithm_name_from_file, register_algorithm
from rlx_tpu_torch.algorithms.ddpg.cuda.ddpg import DDPG
from rlx_tpu_torch.algorithms.ddpg.cuda.default_config import get_config
from rlx_tpu_torch.algorithms.ddpg.cuda.general_properties import GeneralProperties

DDPG_CUDA = extract_algorithm_name_from_file(__file__)
register_algorithm(DDPG_CUDA, get_config, lambda: DDPG, GeneralProperties)
