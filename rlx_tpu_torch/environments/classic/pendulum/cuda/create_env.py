from rlx_tpu_torch.environments.classic.pendulum.cuda.environment import Pendulum
from rlx_tpu_torch.environments.classic.pendulum.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.environments.wrappers import ObservationMaskWrapper


def create_train_and_eval_env(config):
    env_config = config.environment
    train_env = Pendulum(env_config.nr_envs, env_config.horizon, device=config.runner.device)
    eval_env = Pendulum(env_config.nr_envs, env_config.horizon, device=config.runner.device)
    if env_config.mask_velocity:
        # POMDP variant: the observation is [cos th, sin th] only, which
        # needs memory to solve
        train_env = ObservationMaskWrapper(train_env, [0, 1])
        eval_env = ObservationMaskWrapper(eval_env, [0, 1])
    for env in (train_env, eval_env):
        env.general_properties = GeneralProperties
    return train_env, eval_env
