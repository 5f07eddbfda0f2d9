"""SimbaV2 defaults (the JAX package's ``simbav2.tpu`` values: SAC's and
hypersphere encoders of 128 x 1 block (policy) and 512 x 2 blocks (critics),
101 HL-Gauss atoms over [-5, 5], both running normalizers on, no weight norm;
``shard_local_sampling`` shapes the batch under a dp mesh, ``offpolicy.py``;
``nr_parallel_seeds`` above 1 runs the seeds in one program)."""

from rlx_tpu_torch.algorithms.sac.cuda.default_config import get_config as sac_config


def get_config(algorithm_name):
    config = sac_config(algorithm_name)
    config.update(policy_hidden_dim=128, policy_nr_blocks=1, critic_hidden_dim=512, critic_nr_blocks=2, nr_atoms=101,
                  v_min=-5.0, v_max=5.0, policy_delay=1, enable_observation_normalization=True,
                  enable_reward_normalization=True, use_weight_norm=False, normalize_last_layer=False)
    return config
