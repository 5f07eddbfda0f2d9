from rlx_tpu_torch.algorithms.algorithm_manager import extract_algorithm_name_from_file, register_algorithm
from rlx_tpu_torch.algorithms.sac.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.simba.cuda.simba import SimBa
from rlx_tpu_torch.algorithms.simba.cuda.default_config import get_config

SIMBA_CUDA = extract_algorithm_name_from_file(__file__)
register_algorithm(SIMBA_CUDA, get_config, lambda: SimBa, GeneralProperties)
