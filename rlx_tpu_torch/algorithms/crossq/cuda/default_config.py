"""CrossQ defaults (the JAX package's ``crossq.tpu`` values: SAC's with 2048 x
2048 critics, policy delay 3 and batch-renorm momentum 0.99;
``shard_local_sampling`` shapes the batch under a dp mesh, ``offpolicy.py``;
``nr_parallel_seeds`` above 1 runs the seeds in one program)."""

from rlx_tpu_torch.algorithms.sac.cuda.default_config import get_config as sac_config


def get_config(algorithm_name):
    config = sac_config(algorithm_name)
    config.update(critic_hidden_sizes=(2048, 2048), policy_delay=3, batch_renorm_momentum=0.99)
    return config
