"""REPPO defaults (the JAX package's ``reppo.tpu`` values, every key;
``nr_parallel_seeds`` above 1 raises ``NotImplementedError``;
``policy_min_std`` and ``anneal_learning_rate`` are unread, as in JAX)."""

from rlx_tpu_torch.utils.config_dict import ConfigDict


def get_config(algorithm_name):
    return ConfigDict(
        name=algorithm_name,
        total_timesteps=1_000_000,
        learning_rate=3e-4,
        anneal_learning_rate=False,
        nr_steps=128,
        nr_epochs=4,
        nr_minibatches=8,
        gamma=0.99,
        gae_lambda=0.95,
        max_grad_norm=0.5,
        policy_hidden_dim=512,
        critic_hidden_dim=512,
        policy_min_std=0.0,
        nr_bins=151,
        v_min=-100.0,
        v_max=100.0,
        init_kl_coefficient=0.01,
        kl_bound=0.1,
        init_entropy_coefficient=0.01,
        target_entropy_multiplier=0.5,
        auxiliary_loss_coefficient=1.0,
        nr_kl_samples=16,
        normalize_observation=True,
        evaluation_and_save_frequency=-1,
        evaluation_active=True,
        logging_active=True,
        nr_parallel_seeds=1,
    )
