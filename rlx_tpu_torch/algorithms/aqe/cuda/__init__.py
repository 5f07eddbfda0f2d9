from rlx_tpu_torch.algorithms.algorithm_manager import extract_algorithm_name_from_file, register_algorithm
from rlx_tpu_torch.algorithms.aqe.cuda.aqe import AQE
from rlx_tpu_torch.algorithms.aqe.cuda.default_config import get_config
from rlx_tpu_torch.algorithms.sac.cuda.general_properties import GeneralProperties

AQE_CUDA = extract_algorithm_name_from_file(__file__)
register_algorithm(AQE_CUDA, get_config, lambda: AQE, GeneralProperties)
