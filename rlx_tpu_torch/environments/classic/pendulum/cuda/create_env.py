from rlx_tpu_torch.environments.classic.pendulum.cuda.environment import Pendulum
from rlx_tpu_torch.environments.classic.pendulum.cuda.general_properties import GeneralProperties


def create_train_and_eval_env(config):
    env_config = config.environment
    if env_config.mask_velocity:
        raise NotImplementedError("mask_velocity needs environments/wrappers.py, which is not ported yet")
    train_env = Pendulum(env_config.nr_envs, env_config.horizon, device=config.runner.device)
    eval_env = Pendulum(env_config.nr_envs, env_config.horizon, device=config.runner.device)
    for env in (train_env, eval_env):
        env.general_properties = GeneralProperties
    return train_env, eval_env
