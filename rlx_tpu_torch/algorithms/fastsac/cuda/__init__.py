from rlx_tpu_torch.algorithms.algorithm_manager import extract_algorithm_name_from_file, register_algorithm
from rlx_tpu_torch.algorithms.fastsac.cuda.default_config import get_config
from rlx_tpu_torch.algorithms.fastsac.cuda.fastsac import FastSAC
from rlx_tpu_torch.algorithms.sac.cuda.general_properties import GeneralProperties

FASTSAC_CUDA = extract_algorithm_name_from_file(__file__)
register_algorithm(FASTSAC_CUDA, get_config, lambda: FastSAC, GeneralProperties)
