"""SimBa defaults (the JAX package's ``simba.tpu`` values: SAC's and residual
encoders of 128 x 1 block (policy) and 512 x 2 blocks (critics); the MLP sizes
stay and go unused; its ``shard_local_sampling`` key is left out with the mesh,
so setting it raises ``KeyError``; ``nr_parallel_seeds`` (1 by default) trains
that many seeds in one program, ``algorithms/parallel_seeds.py``)."""

from rlx_tpu_torch.algorithms.sac.cuda.default_config import get_config as sac_config


def get_config(algorithm_name):
    config = sac_config(algorithm_name)
    config.update(policy_hidden_dim=128, policy_nr_blocks=1, critic_hidden_dim=512, critic_nr_blocks=2)
    return config
