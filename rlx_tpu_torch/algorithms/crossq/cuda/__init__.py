from rlx_tpu_torch.algorithms.algorithm_manager import extract_algorithm_name_from_file, register_algorithm
from rlx_tpu_torch.algorithms.sac.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.crossq.cuda.crossq import CrossQ
from rlx_tpu_torch.algorithms.crossq.cuda.default_config import get_config

CROSSQ_CUDA = extract_algorithm_name_from_file(__file__)
register_algorithm(CROSSQ_CUDA, get_config, lambda: CrossQ, GeneralProperties)
