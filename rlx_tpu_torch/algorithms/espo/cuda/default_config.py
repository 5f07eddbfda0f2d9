"""ESPO defaults (the JAX package's ``espo.tpu`` values; its
``nr_parallel_seeds`` key is left out with parallel seeds, so setting it
raises ``KeyError``)."""

from rlx_tpu_torch.utils.config_dict import ConfigDict


def get_config(algorithm_name):
    return ConfigDict(
        name=algorithm_name,
        total_timesteps=1_000_000,
        learning_rate=3e-4,
        anneal_learning_rate=True,
        nr_steps=128,
        nr_epochs=10,
        minibatch_size=64,
        gamma=0.99,
        gae_lambda=0.95,
        clip_range=0.2,
        max_ratio_delta=0.25,
        delta_calc_operator="mean",   # mean, median
        entropy_coef=0.0,
        critic_coef=0.5,
        max_grad_norm=0.5,
        std_dev=1.0,
        action_clipping_and_rescaling=False,
        policy_hidden_sizes=(64, 64),
        critic_hidden_sizes=(64, 64),
        activation="tanh",
        layer_norm=False,
        evaluation_and_save_frequency=-1,
        evaluation_active=True,
        logging_active=True,
    )
