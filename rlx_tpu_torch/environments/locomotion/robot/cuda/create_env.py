from rlx_tpu_torch.environments.locomotion.robot.cuda.environment import LocomotionEnv
from rlx_tpu_torch.environments.locomotion.robot.cuda.general_properties import GeneralProperties


def create_train_and_eval_env(config, env_class=LocomotionEnv, general_properties=GeneralProperties):
    """(train env, eval env) on ``runner.device``; the eval env is the train
    env itself with ``copy_train_env_for_eval``."""
    env_config = config.environment
    train_env = env_class(env_config, env_config.nr_envs, device=config.runner.device)
    train_env.general_properties = general_properties
    if env_config.copy_train_env_for_eval:
        return train_env, train_env
    eval_env = env_class(env_config, env_config.nr_envs, device=config.runner.device)
    eval_env.general_properties = general_properties
    return train_env, eval_env
