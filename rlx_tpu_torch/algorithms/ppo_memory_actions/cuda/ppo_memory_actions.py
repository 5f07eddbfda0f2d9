"""PPO with learned memory through the action space, the JAX package's
``ppo_memory_actions.tpu``: standard PPO on the env wrapped in
``MemoryActionsWrapper`` (``memory_action_dimension`` extra action entries,
clipped to +-``memory_action_clip``, appended to the next observation).
An eval env that is the train env stays shared."""

from rlx_tpu_torch.algorithms.ppo.cuda.ppo import PPO
from rlx_tpu_torch.algorithms.ppo_memory_actions.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.environments.wrappers import MemoryActionsWrapper


class PPOMemoryActions(PPO):
    def __init__(self, config, train_env, eval_env, run_path=None, writer=None):
        a = config.algorithm
        wrap = lambda env: MemoryActionsWrapper(env, a.memory_action_dimension, memory_clip=a.memory_action_clip)
        wrapped_train = wrap(train_env)
        wrapped_eval = wrapped_train if eval_env is train_env else wrap(eval_env)
        super().__init__(config, wrapped_train, wrapped_eval, run_path, writer)

    def general_properties():
        return GeneralProperties
