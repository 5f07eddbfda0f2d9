"""MPO defaults (the JAX package's ``mpo.tpu`` values; ``shard_local_sampling``
shapes the batch under a dp mesh, ``offpolicy.py``; ``nr_parallel_seeds``
above 1 runs the seeds in one program)."""

from rlx_tpu_torch.utils.config_dict import ConfigDict


def get_config(algorithm_name):
    return ConfigDict(
        name=algorithm_name,
        total_timesteps=1_000_000,
        learning_rate=3e-4,
        dual_learning_rate=1e-2,
        anneal_learning_rate=False,
        buffer_size=1_000_000,
        learning_starts=5_000,
        batch_size=256,
        actor_update_period=1_000,
        target_network_update_period=100,
        gamma=0.99,
        n_step=4,
        action_sampling_number=20,
        max_grad_norm=40.0,
        epsilon_non_parametric=0.1,
        epsilon_parametric_mu=0.01,
        epsilon_parametric_sigma=1e-6,
        epsilon_penalty=0.001,
        action_penalization=True,
        init_log_eta=10.0,
        init_log_alpha_mean=10.0,
        init_log_alpha_stddev=1000.0,
        init_log_penalty_temperature=10.0,
        policy_init_scale=0.5,
        policy_min_scale=1e-6,
        v_min=-1600.0,
        v_max=1600.0,
        nr_atoms=51,
        enable_observation_normalization=False,
        policy_hidden_sizes=(256, 256),
        critic_hidden_sizes=(256, 256),
        activation="elu",
        layer_norm=True,
        logging_frequency=5_000,
        evaluation_and_save_frequency=-1,
        evaluation_active=True,
        logging_active=True,
        # dp > 1: batch row i reads env shard i % dp (False: uniform over all envs)
        shard_local_sampling=True,
        nr_parallel_seeds=1,
    )
