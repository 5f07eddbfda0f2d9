from rlx_tpu_torch.algorithms.algorithm_manager import extract_algorithm_name_from_file, register_algorithm
from rlx_tpu_torch.algorithms.ppo_gru.cuda.default_config import get_config
from rlx_tpu_torch.algorithms.ppo_gru.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.ppo_gru.cuda.ppo_gru import PPOGRU

PPO_GRU_CUDA = extract_algorithm_name_from_file(__file__)
register_algorithm(PPO_GRU_CUDA, get_config, lambda: PPOGRU, GeneralProperties)
