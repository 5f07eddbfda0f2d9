"""FlashSAC defaults (the JAX package's ``flashsac.tpu`` values: the warmup-cosine
learning-rate band, the categorical critic's grid and the zeta noise; its
``shard_local_sampling`` key is left out with the mesh, so setting it raises
``KeyError``; ``nr_parallel_seeds`` above 1 raises ``NotImplementedError``,
ROADMAP Queue A item 19c)."""

from rlx_tpu_torch.utils.config_dict import ConfigDict


def get_config(algorithm_name):
    return ConfigDict(
        name=algorithm_name,
        total_timesteps=1_000_000,
        learning_rate=3e-4,   # the core's bookkeeping; the optimizers follow the schedule below
        learning_rate_init=3e-4,
        learning_rate_peak=3e-4,
        learning_rate_end=1.5e-4,
        learning_rate_warmup_steps=0,
        buffer_size=1_000_000,
        learning_starts=10_000,
        batch_size=512,
        policy_delay=2,
        gamma=0.99,
        n_step=1,
        tau=0.01,
        policy_hidden_dim=128,
        policy_nr_blocks=2,
        critic_hidden_dim=256,
        critic_nr_blocks=2,
        nr_critics=2,
        nr_atoms=101,
        normalized_g_max=5.0,
        v_min=-5.0,
        v_max=5.0,
        init_entropy_coefficient=0.01,
        target_entropy_sigma=0.15,
        enable_reward_normalization=True,
        noise_zeta_mu=2.0,
        noise_zeta_max_repeat=16,
        logging_frequency=5_000,
        evaluation_and_save_frequency=-1,
        evaluation_active=True,
        logging_active=True,
        nr_parallel_seeds=1,
    )
