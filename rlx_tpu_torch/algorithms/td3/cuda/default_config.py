"""TD3 defaults (the JAX package's ``td3.tpu`` values; its
``shard_local_sampling`` key is left out with the mesh, so setting it raises
``KeyError``; ``nr_parallel_seeds`` (1 by default) trains that many seeds in
one program, ``algorithms/parallel_seeds.py``). ``anneal_learning_rate`` is
kept for the JAX package's command lines; TD3 does not read it there either."""

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
        epsilon=0.1,
        smoothing_epsilon=0.2,
        smoothing_clip_value=0.5,
        policy_delay=2,
        policy_hidden_sizes=(256, 256),
        critic_hidden_sizes=(256, 256),
        activation="relu",
        layer_norm=False,
        logging_frequency=3_000,
        evaluation_and_save_frequency=-1,
        evaluation_active=True,
        logging_active=True,
        nr_parallel_seeds=1,
    )
