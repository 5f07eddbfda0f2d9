from rlx_tpu_torch.algorithms.algorithm_manager import extract_algorithm_name_from_file, register_algorithm
from rlx_tpu_torch.algorithms.espo.cuda.default_config import get_config
from rlx_tpu_torch.algorithms.espo.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.espo.cuda.espo import ESPO

ESPO_CUDA = extract_algorithm_name_from_file(__file__)
register_algorithm(ESPO_CUDA, get_config, lambda: ESPO, GeneralProperties)
