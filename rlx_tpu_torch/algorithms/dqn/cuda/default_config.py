"""DQN defaults (the JAX package's ``dqn.tpu`` values; ``shard_local_sampling``
shapes the batch under a dp mesh, ``offpolicy.py``; ``nr_parallel_seeds`` (1
by default) trains that many seeds in one program,
``algorithms/parallel_seeds.py``). ``anneal_learning_rate`` is kept for the
JAX package's command lines; DQN does not read it there either."""

from rlx_tpu_torch.utils.config_dict import ConfigDict


def get_config(algorithm_name):
    return ConfigDict(
        name=algorithm_name,
        total_timesteps=500_000,
        learning_rate=3e-4,
        anneal_learning_rate=False,
        buffer_size=100_000,
        learning_starts=10_000,
        batch_size=32,
        gamma=0.99,
        epsilon_start=1.0,
        epsilon_end=0.01,
        epsilon_decay_steps=250_000,
        update_frequency=4,
        target_update_frequency=8_000,
        critic_hidden_sizes=(512,),
        activation="relu",
        logging_frequency=1_000,
        evaluation_and_save_frequency=-1,
        evaluation_active=True,
        logging_active=True,
        # dp > 1: batch row i reads env shard i % dp (False: uniform over all envs)
        shard_local_sampling=True,
        nr_parallel_seeds=1,
    )
