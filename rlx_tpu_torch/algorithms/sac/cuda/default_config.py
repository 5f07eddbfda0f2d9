"""SAC defaults (the JAX package's ``sac.tpu`` values; ``shard_local_sampling``
shapes the batch under a dp mesh, ``offpolicy.py``; ``nr_parallel_seeds`` (1
by default) trains that many seeds in one program,
``algorithms/parallel_seeds.py``)."""

from rlx_tpu_torch.utils.config_dict import ConfigDict


def get_config(algorithm_name):
    return ConfigDict(
        name=algorithm_name,
        total_timesteps=1_000_000,
        learning_rate=3e-4,
        anneal_learning_rate=False,
        buffer_size=1_000_000,
        learning_starts=5_000,
        batch_size=256,
        tau=0.005,
        gamma=0.99,
        # "auto" is -action_dim; anything else is read as a float
        target_entropy="auto",
        log_std_min=-20.0,
        log_std_max=2.0,
        policy_hidden_sizes=(256, 256),
        critic_hidden_sizes=(256, 256),
        nr_critics=2,
        activation="relu",
        layer_norm=False,
        logging_frequency=5_000,
        evaluation_and_save_frequency=-1,
        evaluation_active=True,
        logging_active=True,
        # dp > 1: batch row i reads env shard i % dp (False: uniform over all envs)
        shard_local_sampling=True,
        nr_parallel_seeds=1,
    )
