"""XQC defaults (the JAX package's ``xqc.tpu`` values: SAC's and SimBa trunks of
256 x 4 blocks (policy) and 512 x 4 blocks (critics), 101 HL-Gauss atoms over
[-5, 5], policy delay 3 and the weight norm with the heads;
``shard_local_sampling`` shapes the batch under a dp mesh, ``offpolicy.py``;
``nr_parallel_seeds`` above 1 runs the seeds in one program)."""

from rlx_tpu_torch.algorithms.sac.cuda.default_config import get_config as sac_config


def get_config(algorithm_name):
    config = sac_config(algorithm_name)
    config.update(policy_hidden_dim=256, policy_nr_blocks=4, critic_hidden_dim=512, critic_nr_blocks=4, nr_atoms=101,
                  v_min=-5.0, v_max=5.0, policy_delay=3, use_weight_norm=True, normalize_last_layer=True)
    return config
