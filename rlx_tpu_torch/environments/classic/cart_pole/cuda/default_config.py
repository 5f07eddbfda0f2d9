"""CartPole env defaults (same values as the JAX package's ``classic.cart_pole.tpu``)."""

from rlx_tpu_torch.utils.config_dict import ConfigDict


def get_config(environment_name):
    return ConfigDict(name=environment_name, seed=1, nr_envs=8, horizon=500,
                      render=False)  # the JAX package's key; nothing reads it
