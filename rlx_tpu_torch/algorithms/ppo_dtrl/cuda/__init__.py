from rlx_tpu_torch.algorithms.algorithm_manager import extract_algorithm_name_from_file, register_algorithm
from rlx_tpu_torch.algorithms.ppo_dtrl.cuda.default_config import get_config
from rlx_tpu_torch.algorithms.ppo_dtrl.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.ppo_dtrl.cuda.ppo_dtrl import PPODTRL

PPO_DTRL_CUDA = extract_algorithm_name_from_file(__file__)
register_algorithm(PPO_DTRL_CUDA, get_config, lambda: PPODTRL, GeneralProperties)
