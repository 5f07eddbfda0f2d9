"""AQE defaults (the JAX package's ``aqe.tpu`` values: SAC's and nr_critics=10,
nr_dropped_q_values=4, q_update_steps=5; its ``shard_local_sampling`` key is
left out with the mesh, so setting it raises ``KeyError``;
``nr_parallel_seeds`` above 1 raises ``NotImplementedError``, ROADMAP Queue A
item 19c)."""

from rlx_tpu_torch.algorithms.sac.cuda.default_config import get_config as sac_config


def get_config(algorithm_name):
    config = sac_config(algorithm_name)
    config.update(nr_critics=10, nr_dropped_q_values=4, q_update_steps=5)
    return config
