from rlx_tpu_torch.algorithms.algorithm_manager import extract_algorithm_name_from_file, register_algorithm
from rlx_tpu_torch.algorithms.mpo.cuda.default_config import get_config
from rlx_tpu_torch.algorithms.mpo.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.mpo.cuda.mpo import MPO

MPO_CUDA = extract_algorithm_name_from_file(__file__)
register_algorithm(MPO_CUDA, get_config, lambda: MPO, GeneralProperties)
