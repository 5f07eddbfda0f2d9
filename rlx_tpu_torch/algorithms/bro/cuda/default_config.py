"""BRO defaults (the JAX package's ``bro.tpu`` values; its
``shard_local_sampling`` key is left out with the mesh, so setting it raises
``KeyError``; ``nr_parallel_seeds`` above 1 raises ``NotImplementedError``,
ROADMAP Queue A item 19c). The BroNet widths are ``*_hidden_dim`` /
``*_nr_blocks``; ``*_hidden_sizes``, ``log_std_*``, ``activation`` and
``layer_norm`` are kept as JAX keeps them, unread."""

from rlx_tpu_torch.utils.config_dict import ConfigDict


def get_config(algorithm_name):
    return ConfigDict(
        name=algorithm_name,
        total_timesteps=1_000_000,
        learning_rate=3e-4,
        anneal_learning_rate=False,
        buffer_size=1_000_000,
        learning_starts=2_500,
        batch_size=128,
        tau=0.005,
        gamma=0.99,
        target_entropy="auto",
        log_std_min=-20.0,
        log_std_max=2.0,
        policy_hidden_sizes=(256, 256),
        critic_hidden_sizes=(256, 256),
        policy_hidden_dim=256,
        policy_nr_blocks=1,
        critic_hidden_dim=512,
        critic_nr_blocks=2,
        nr_quantiles=100,
        updates_per_step=10,
        std_multiplier=0.75,
        use_optimistic_exploration=True,
        adjustment_learning_rate=3e-5,
        pessimism=0.0,
        kl_target=0.05,
        init_optimism=1.0,
        init_regularizer=0.25,
        first_reset_step=15_000,
        reset_interval=500_000,
        nr_critics=2,
        activation="relu",
        layer_norm=False,
        logging_frequency=5_000,
        evaluation_and_save_frequency=-1,
        evaluation_active=True,
        logging_active=True,
        nr_parallel_seeds=1,
    )
