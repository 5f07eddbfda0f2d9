"""Ant env defaults (same values as the JAX package's ``locomotion.ant.tpu``)."""

from rlx_tpu_torch.utils.config_dict import ConfigDict


def get_config(environment_name):
    return ConfigDict(
        name=environment_name,
        seed=1,
        nr_envs=4096,
        horizon=1000,
        action_scaling_factor=0.3,
        nr_substeps=4,
        copy_train_env_for_eval=True,
        initial_state_noise=0.0,
        perturbation_chance=0.0,
        perturbation_velocity=0.5,
        # the JAX package's key; nothing reads it
        render=False,
    )
