from rlx_tpu_torch.algorithms.algorithm_manager import extract_algorithm_name_from_file, register_algorithm
from rlx_tpu_torch.algorithms.flashsac.cuda.default_config import get_config
from rlx_tpu_torch.algorithms.flashsac.cuda.flashsac import FlashSAC
from rlx_tpu_torch.algorithms.sac.cuda.general_properties import GeneralProperties

FLASHSAC_CUDA = extract_algorithm_name_from_file(__file__)
register_algorithm(FLASHSAC_CUDA, get_config, lambda: FlashSAC, GeneralProperties)
