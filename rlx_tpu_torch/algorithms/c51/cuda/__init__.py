from rlx_tpu_torch.algorithms.algorithm_manager import extract_algorithm_name_from_file, register_algorithm
from rlx_tpu_torch.algorithms.c51.cuda.default_config import get_config
from rlx_tpu_torch.algorithms.c51.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.c51.cuda.c51 import C51

C51_CUDA = extract_algorithm_name_from_file(__file__)
register_algorithm(C51_CUDA, get_config, lambda: C51, GeneralProperties)
