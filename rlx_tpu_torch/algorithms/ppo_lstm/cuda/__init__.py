from rlx_tpu_torch.algorithms.algorithm_manager import extract_algorithm_name_from_file, register_algorithm
from rlx_tpu_torch.algorithms.ppo_lstm.cuda.default_config import get_config
from rlx_tpu_torch.algorithms.ppo_lstm.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.ppo_lstm.cuda.ppo_lstm import PPOLSTM

PPO_LSTM_CUDA = extract_algorithm_name_from_file(__file__)
register_algorithm(PPO_LSTM_CUDA, get_config, lambda: PPOLSTM, GeneralProperties)
