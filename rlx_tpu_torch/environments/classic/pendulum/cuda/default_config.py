"""Pendulum env defaults (same values as the JAX package's ``classic.pendulum.tpu``)."""

from rlx_tpu_torch.utils.config_dict import ConfigDict


def get_config(environment_name):
    return ConfigDict(
        name=environment_name,
        seed=1,
        nr_envs=8,
        horizon=200,
        # POMDP variant: the observation mask wrapper hides the angular
        # velocity
        mask_velocity=False,
        # the JAX package's key; nothing reads it
        render=False,
    )
