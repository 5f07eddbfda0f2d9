from rlx_tpu_torch.algorithms.algorithm_manager import extract_algorithm_name_from_file, register_algorithm
from rlx_tpu_torch.algorithms.sac.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.simbav2.cuda.simbav2 import SimbaV2
from rlx_tpu_torch.algorithms.simbav2.cuda.default_config import get_config

SIMBAV2_CUDA = extract_algorithm_name_from_file(__file__)
register_algorithm(SIMBAV2_CUDA, get_config, lambda: SimbaV2, GeneralProperties)
