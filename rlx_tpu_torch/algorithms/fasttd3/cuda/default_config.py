"""FastTD3 defaults (the JAX package's ``fasttd3.tpu`` values; its
``shard_local_sampling`` key is left out with the mesh, and
``anneal_learning_rate``, which FastTD3 never reads, is left out too).
``nr_parallel_seeds`` (1 by default) trains that many seeds in one program,
``algorithms/parallel_seeds.py``."""

from rlx_tpu_torch.utils.config_dict import ConfigDict


def get_config(algorithm_name):
    return ConfigDict(
        name=algorithm_name,
        total_timesteps=1_000_000,
        learning_rate=3e-4,
        weight_decay=0.1,
        buffer_size=1_000_000,
        learning_starts=5_000,
        batch_size=256,
        v_min=-10.0,
        v_max=10.0,
        tau=0.1,
        gamma=0.97,
        nr_atoms=101,
        n_step=1,
        noise_std_min=0.001,
        noise_std_max=0.4,
        smoothing_epsilon=0.001,
        smoothing_clip_value=0.5,
        nr_critic_updates_per_policy_update=2,
        clipped_double_q_learning=True,
        enable_observation_normalization=True,
        policy_hidden_sizes=(512, 256, 128),
        critic_hidden_sizes=(512, 256, 128),
        activation="elu",
        layer_norm=True,
        logging_frequency=5_000,
        evaluation_and_save_frequency=-1,
        evaluation_active=True,
        logging_active=True,
        nr_parallel_seeds=1,
    )
