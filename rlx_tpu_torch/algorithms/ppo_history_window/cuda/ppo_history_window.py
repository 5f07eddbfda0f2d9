"""PPO over a window of recent observations, the JAX package's
``ppo_history_window.tpu``: standard PPO on the env wrapped in
``ObservationWindowWrapper`` (the last ``window_length`` observations,
flattened).  An eval env that is the train env stays shared."""

from rlx_tpu_torch.algorithms.ppo.cuda.ppo import PPO
from rlx_tpu_torch.algorithms.ppo_history_window.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.environments.wrappers import ObservationWindowWrapper


class PPOHistoryWindow(PPO):
    def __init__(self, config, train_env, eval_env, run_path=None, writer=None):
        window = config.algorithm.window_length
        wrapped_train = ObservationWindowWrapper(train_env, window)
        wrapped_eval = wrapped_train if eval_env is train_env else ObservationWindowWrapper(eval_env, window)
        super().__init__(config, wrapped_train, wrapped_eval, run_path, writer)

    def general_properties():
        return GeneralProperties
