"""REDQ defaults (the JAX package's ``redq.tpu`` values: SAC's and
nr_critics=10, in_target_minimization=2, q_update_steps=20; its
``shard_local_sampling`` and ``nr_parallel_seeds`` keys are left out with
the mesh and parallel seeds, so setting one raises ``KeyError``)."""

from rlx_tpu_torch.algorithms.sac.cuda.default_config import get_config as sac_config


def get_config(algorithm_name):
    config = sac_config(algorithm_name)
    config.update(nr_critics=10, in_target_minimization=2, q_update_steps=20)
    return config
