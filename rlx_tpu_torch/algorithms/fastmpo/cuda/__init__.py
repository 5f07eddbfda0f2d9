from rlx_tpu_torch.algorithms.algorithm_manager import extract_algorithm_name_from_file, register_algorithm
from rlx_tpu_torch.algorithms.fastmpo.cuda.default_config import get_config
from rlx_tpu_torch.algorithms.fastmpo.cuda.fastmpo import FastMPO
from rlx_tpu_torch.algorithms.fastmpo.cuda.general_properties import GeneralProperties

FASTMPO_CUDA = extract_algorithm_name_from_file(__file__)
register_algorithm(FASTMPO_CUDA, get_config, lambda: FastMPO, GeneralProperties)
