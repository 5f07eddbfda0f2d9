from rlx_tpu_torch.algorithms.algorithm_manager import extract_algorithm_name_from_file, register_algorithm
from rlx_tpu_torch.algorithms.sac.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.xqc.cuda.xqc import XQC
from rlx_tpu_torch.algorithms.xqc.cuda.default_config import get_config

XQC_CUDA = extract_algorithm_name_from_file(__file__)
register_algorithm(XQC_CUDA, get_config, lambda: XQC, GeneralProperties)
