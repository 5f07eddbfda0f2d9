from rlx_tpu_torch.environments.locomotion.ant.cuda.environment import Ant
from rlx_tpu_torch.environments.locomotion.ant.cuda.general_properties import GeneralProperties


def create_train_and_eval_env(config):
    env_config = config.environment
    device = config.runner.device
    train_env = Ant(
        env_config.nr_envs,
        horizon=env_config.horizon,
        action_scaling_factor=env_config.action_scaling_factor,
        nr_substeps=env_config.nr_substeps,
        initial_state_noise=env_config.initial_state_noise,
        perturbation_chance=env_config.perturbation_chance,
        perturbation_velocity=env_config.perturbation_velocity,
        device=device,
    )
    train_env.general_properties = GeneralProperties
    if env_config.copy_train_env_for_eval:
        return train_env, train_env
    eval_env = Ant(
        env_config.nr_envs,
        horizon=env_config.horizon,
        action_scaling_factor=env_config.action_scaling_factor,
        nr_substeps=env_config.nr_substeps,
        device=device,
    )
    eval_env.general_properties = GeneralProperties
    return train_env, eval_env
