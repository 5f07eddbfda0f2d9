"""TQC defaults (the JAX package's ``tqc.tpu`` values: SAC's and 2 nets of 25
quantile atoms, 2 dropped per net; its ``shard_local_sampling`` key is left out
with the mesh, so setting it raises ``KeyError``; ``nr_parallel_seeds`` above 1
raises ``NotImplementedError``, ROADMAP Queue A item 19c)."""

from rlx_tpu_torch.algorithms.sac.cuda.default_config import get_config as sac_config


def get_config(algorithm_name):
    config = sac_config(algorithm_name)
    config.update(nr_critics=2, nr_atoms_per_net=25, nr_dropped_atoms_per_net=2)
    return config
