from rlx_tpu_torch.environments.classic.cart_pole.cuda.environment import CartPole
from rlx_tpu_torch.environments.classic.cart_pole.cuda.general_properties import GeneralProperties


def create_train_and_eval_env(config):
    env_config = config.environment
    train_env = CartPole(env_config.nr_envs, env_config.horizon, device=config.runner.device)
    eval_env = CartPole(env_config.nr_envs, env_config.horizon, device=config.runner.device)
    for env in (train_env, eval_env):
        env.general_properties = GeneralProperties
    return train_env, eval_env
