"""DroQ defaults (the JAX package's ``droq.tpu`` values: SAC's and nr_critics=2,
dropout_rate=0.01, q_update_steps=20; ``shard_local_sampling`` shapes the
batch under a dp mesh, ``offpolicy.py``; ``nr_parallel_seeds`` above 1 runs
the seeds in one program)."""

from rlx_tpu_torch.algorithms.sac.cuda.default_config import get_config as sac_config


def get_config(algorithm_name):
    config = sac_config(algorithm_name)
    config.update(nr_critics=2, dropout_rate=0.01, q_update_steps=20)
    return config
