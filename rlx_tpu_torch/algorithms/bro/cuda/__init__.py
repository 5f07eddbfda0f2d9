from rlx_tpu_torch.algorithms.algorithm_manager import extract_algorithm_name_from_file, register_algorithm
from rlx_tpu_torch.algorithms.bro.cuda.bro import BRO
from rlx_tpu_torch.algorithms.bro.cuda.default_config import get_config
from rlx_tpu_torch.algorithms.bro.cuda.general_properties import GeneralProperties

BRO_CUDA = extract_algorithm_name_from_file(__file__)
register_algorithm(BRO_CUDA, get_config, lambda: BRO, GeneralProperties)
