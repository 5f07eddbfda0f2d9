from rlx_tpu_torch.algorithms.algorithm_manager import extract_algorithm_name_from_file, register_algorithm
from rlx_tpu_torch.algorithms.sac.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.tqc.cuda.default_config import get_config
from rlx_tpu_torch.algorithms.tqc.cuda.tqc import TQC

TQC_CUDA = extract_algorithm_name_from_file(__file__)
register_algorithm(TQC_CUDA, get_config, lambda: TQC, GeneralProperties)
