"""GRU PPO defaults (the JAX package's ``ppo_gru.tpu`` values, every key;
``nr_parallel_seeds`` (1 by default) trains that many seeds in one program,
``algorithms/parallel_seeds.py``)."""

from rlx_tpu_torch.utils.config_dict import ConfigDict


def get_config(algorithm_name):
    return ConfigDict(
        name=algorithm_name,
        total_timesteps=1_000_000,
        learning_rate=3e-4,
        anneal_learning_rate=True,
        nr_steps=128,
        nr_epochs=10,
        nr_minibatches=4,
        gamma=0.99,
        gae_lambda=0.95,
        clip_range=0.2,
        entropy_coef=0.0,
        critic_coef=0.5,
        max_grad_norm=0.5,
        std_dev=1.0,
        action_clipping_and_rescaling=False,
        obs_encoding_dim=128,
        rnn_hidden_dim=64,
        rnn_obs_combine_method="concat",  # concat, film
        share_rnn_obs_encoder=False,
        critic_hidden_sizes=(512, 256, 128),
        activation="elu",
        layer_norm=True,
        evaluation_and_save_frequency=-1,
        evaluation_active=True,
        logging_active=True,
        nr_parallel_seeds=1,
    )
