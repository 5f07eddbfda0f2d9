from rlx_tpu_torch.algorithms.algorithm_manager import extract_algorithm_name_from_file, register_algorithm
from rlx_tpu_torch.algorithms.fasttd3.cuda.default_config import get_config
from rlx_tpu_torch.algorithms.fasttd3.cuda.fasttd3 import FastTD3
from rlx_tpu_torch.algorithms.fasttd3.cuda.general_properties import GeneralProperties

FASTTD3_CUDA = extract_algorithm_name_from_file(__file__)
register_algorithm(FASTTD3_CUDA, get_config, lambda: FastTD3, GeneralProperties)
