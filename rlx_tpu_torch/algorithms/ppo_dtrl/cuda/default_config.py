"""PPO-DTRL defaults (the JAX package's ``ppo_dtrl.tpu`` values;
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
        minibatch_size=64,
        gamma=0.99,
        gae_lambda=0.95,
        clip_range=0.2,
        mean_bound=0.03,
        cov_bound=0.001,
        trust_region_coef=10.0,
        entropy_projection_active=False,
        min_entropy=-4.0,
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
        nr_parallel_seeds=1,
    )
