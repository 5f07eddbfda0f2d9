"""FastMPO defaults (the JAX package's ``fastmpo.tpu`` values, the FastSAC flavor
of the recipe; ``shard_local_sampling`` shapes the batch under a dp mesh,
``offpolicy.py``; ``nr_parallel_seeds`` above 1 runs the seeds in one
program)."""

from rlx_tpu_torch.utils.config_dict import ConfigDict


def get_config(algorithm_name):
    return ConfigDict(
        name=algorithm_name,
        total_timesteps=1_000_000,
        critic_network_type="fastsac",   # fastsac, fasttd3, mpo
        dual_critic=True,
        policy_network_type="fastsac",   # fastsac, fasttd3, mpo
        action_clipping=False,
        action_rescaling="none",         # none, fastsac, normal
        learning_rate=3e-4,
        policy_learning_rate=3e-4,
        critic_learning_rate=3e-4,
        dual_learning_rate=1e-2,
        anneal_learning_rate=False,
        policy_weight_decay=0.001,
        critic_weight_decay=0.001,
        dual_weight_decay=0.0,
        adam_beta1=0.9,
        adam_beta2=0.95,
        max_grad_norm=40.0,
        collect_data_with_online_policy=False,
        action_sampling_number=4,
        epsilon_non_parametric=0.1,
        epsilon_parametric_mu=0.01,
        epsilon_parametric_sigma=1e-6,
        epsilon_penalty=0.001,
        action_penalization=False,
        init_log_eta=10.0,
        init_log_alpha_mean=10.0,
        init_log_alpha_stddev=1000.0,
        init_log_penalty_temperature=10.0,
        min_log_temperature=-18.0,
        min_log_alpha=-18.0,
        policy_init_scale=0.5,
        policy_min_scale=0.1,
        batch_size=8192,                 # fastsac: 8192, fasttd3: 32768
        buffer_size_per_env=1024,        # fastsac: 1024, fasttd3: 10240
        learning_starts=0,               # derived: learning_starts_per_env * nr_envs
        learning_starts_per_env=10,
        v_min=-20.0,                     # fastsac: +-20, fasttd3: +-10
        v_max=20.0,
        critic_tau=0.125,                # fastsac: 0.125, fasttd3: 0.1
        policy_tau=0.3,
        gamma=0.97,
        nr_atoms=101,
        n_step=1,
        clipped_double_q_learning=False,
        nr_critic_updates_per_policy_update=4,   # fastsac: 4, fasttd3: 2
        nr_policy_updates_per_step=2,            # fastsac: 2, fasttd3: 1
        enable_observation_normalization=True,
        policy_hidden_sizes=(512, 256, 128),     # used for network type "mpo"
        critic_hidden_sizes=(768, 384, 192),
        activation="silu",
        layer_norm=True,
        logging_frequency=40_960,
        evaluation_and_save_frequency=-1,
        evaluation_active=False,
        logging_active=True,
        # dp > 1: batch row i reads env shard i % dp (False: uniform over all envs)
        shard_local_sampling=True,
        nr_parallel_seeds=1,
    )
