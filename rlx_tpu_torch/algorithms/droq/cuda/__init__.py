from rlx_tpu_torch.algorithms.algorithm_manager import extract_algorithm_name_from_file, register_algorithm
from rlx_tpu_torch.algorithms.droq.cuda.droq import DroQ
from rlx_tpu_torch.algorithms.droq.cuda.default_config import get_config
from rlx_tpu_torch.algorithms.sac.cuda.general_properties import GeneralProperties

DROQ_CUDA = extract_algorithm_name_from_file(__file__)
register_algorithm(DROQ_CUDA, get_config, lambda: DroQ, GeneralProperties)
