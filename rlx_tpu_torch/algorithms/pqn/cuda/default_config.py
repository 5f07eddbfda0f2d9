"""PQN defaults (the JAX package's ``pqn.tpu`` values; ``nr_parallel_seeds`` (1 by
default) trains that many seeds in one program,
``algorithms/parallel_seeds.py``)."""

from rlx_tpu_torch.utils.config_dict import ConfigDict


def get_config(algorithm_name):
    return ConfigDict(
        name=algorithm_name,
        total_timesteps=5_000_000,
        learning_rate=2.5e-4,
        anneal_learning_rate=False,
        nr_steps=32,
        nr_epochs=2,
        nr_minibatches=4,
        gamma=0.99,
        q_lambda=0.65,
        epsilon_start=1.0,
        epsilon_end=0.001,
        epsilon_decay_fraction=0.1,
        max_grad_norm=10.0,
        critic_hidden_sizes=(512,),
        activation="relu",
        evaluation_and_save_frequency=-1,
        evaluation_active=True,
        logging_active=True,
        nr_parallel_seeds=1,
    )
