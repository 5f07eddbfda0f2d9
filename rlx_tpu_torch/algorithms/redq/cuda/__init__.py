from rlx_tpu_torch.algorithms.algorithm_manager import extract_algorithm_name_from_file, register_algorithm
from rlx_tpu_torch.algorithms.redq.cuda.redq import REDQ
from rlx_tpu_torch.algorithms.redq.cuda.default_config import get_config
from rlx_tpu_torch.algorithms.sac.cuda.general_properties import GeneralProperties

REDQ_CUDA = extract_algorithm_name_from_file(__file__)
register_algorithm(REDQ_CUDA, get_config, lambda: REDQ, GeneralProperties)
