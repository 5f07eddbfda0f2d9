"""Asymmetric observation indices in the port against the JAX package.

An env may name the observation columns its policy and its critic read
(``policy_observation_indices`` / ``critic_observation_indices``; the robot
envs do).  Here the Pendulum of both packages gets a policy set of two
columns and a critic set that permutes the three, and for PPO (through
``make_policy`` / ``make_critic``), PPO-LSTM, REPPO and every off-policy
family whose JAX nets take the indices, the JAX parameters are carried
into the port (``convert``; loading them needs first layers as wide as
JAX's, ``len(indices)``), and one policy and one critic forward pass on the same inputs
agree (1e-5).
"""

import numpy as np
import pytest
import torch

from rlx_tpu_torch import convert
from rlx_tpu_torch.config import create_env, create_model, make_config
from torch_parity import close, np_tree
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

POLICY_INDICES = [2, 0]
CRITIC_INDICES = [1, 2, 0]
B = 8

SMALL = {
    "ppo": {"algorithm.policy_hidden_sizes": (16, 16), "algorithm.critic_hidden_sizes": (16, 16)},
    "ppo_lstm": {"algorithm.nr_steps": 4},
    "reppo": {"algorithm.policy_hidden_dim": 16, "algorithm.critic_hidden_dim": 16, "algorithm.nr_steps": 4},
    "td3": {"algorithm.policy_hidden_sizes": (16, 16), "algorithm.critic_hidden_sizes": (16, 16)},
    "ddpg": {"algorithm.policy_hidden_sizes": (16, 16), "algorithm.critic_hidden_sizes": (16, 16)},
    "sac": {"algorithm.policy_hidden_sizes": (16, 16), "algorithm.critic_hidden_sizes": (16, 16)},
    "fasttd3": {"algorithm.policy_hidden_sizes": (16, 16), "algorithm.critic_hidden_sizes": (16, 16)},
    "fastsac": {"algorithm.policy_hidden_sizes": (16, 16), "algorithm.critic_hidden_sizes": (16, 16)},
    "flashsac": {"algorithm.policy_hidden_dim": 8, "algorithm.critic_hidden_dim": 16,
                 "algorithm.policy_nr_blocks": 1, "algorithm.critic_nr_blocks": 1},
    "tqc": {"algorithm.policy_hidden_sizes": (16, 16), "algorithm.critic_hidden_sizes": (16, 16)},
    "simba": {"algorithm.policy_hidden_dim": 8, "algorithm.critic_hidden_dim": 16},
    "simbav2": {"algorithm.policy_hidden_dim": 8, "algorithm.critic_hidden_dim": 16, "algorithm.nr_atoms": 11},
    "xqc": {"algorithm.policy_hidden_dim": 8, "algorithm.critic_hidden_dim": 16, "algorithm.nr_atoms": 11},
    "crossq": {"algorithm.policy_hidden_sizes": (16, 8), "algorithm.critic_hidden_sizes": (32, 32)},
    "bro": {"algorithm.policy_hidden_dim": 8, "algorithm.critic_hidden_dim": 16, "algorithm.critic_nr_blocks": 1,
            "algorithm.nr_quantiles": 7},
    "mpo": {"algorithm.policy_hidden_sizes": (16, 16), "algorithm.critic_hidden_sizes": (16, 16)},
    "fastmpo": {"algorithm.policy_network_type": "mlp", "algorithm.critic_network_type": "mlp",
                "algorithm.policy_hidden_sizes": (16, 16), "algorithm.critic_hidden_sizes": (16, 16)},
}


def _with_indices(env):
    env.policy_observation_indices = np.asarray(POLICY_INDICES, np.int32)
    env.critic_observation_indices = np.asarray(CRITIC_INDICES, np.int32)
    return env


def _models(algorithm):
    """(JAX model, port model on the CPU), each on its package's Pendulum
    with the index sets."""
    import jax.numpy as jnp

    from rlx_tpu.config import create_env as jax_create_env
    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config

    overrides = {"environment.nr_envs": 4, "algorithm.evaluation_active": False, **SMALL[algorithm]}
    if algorithm in ("td3", "ddpg", "sac", "fasttd3", "fastsac", "flashsac", "tqc", "simba", "simbav2", "xqc",
                     "crossq", "bro", "mpo", "fastmpo"):
        overrides["algorithm.batch_size"] = B
    jconfig = jax_make_config(f"{algorithm}.tpu", "classic.pendulum.tpu", **overrides, **{"runner.mesh_dp": 1})
    jenv, _ = jax_create_env(jconfig)
    jenv = _with_indices(jenv)
    jenv.policy_observation_indices = jnp.asarray(jenv.policy_observation_indices)
    jenv.critic_observation_indices = jnp.asarray(jenv.critic_observation_indices)
    config = make_config(f"{algorithm}.cuda", "classic.pendulum.cuda", **overrides, **{"runner.device": "cpu"})
    env, _ = create_env(config)
    env = _with_indices(env)
    return (jax_create_model(jconfig, jenv, jenv),
            create_model(config, env, env))


def _inputs(rng):
    obs = (2.0 * rng.normal(size=(B, 3))).astype(np.float32)
    action = rng.uniform(-1, 1, size=(B, 1)).astype(np.float32)
    return obs, action


def _on_policy(algorithm, jmodel, model, obs, action):
    import jax.numpy as jnp

    policy_params, critic_params = np_tree(jmodel.policy_state.params), np_tree(jmodel.critic_state.params)
    if algorithm == "ppo":
        model.policy.module.load_state_dict(convert.policy_state_dict(policy_params))
        model.critic.load_state_dict(convert.critic_state_dict(critic_params))
        policy = model.policy.module
        ours, ref = policy(torch.tensor(obs)), jmodel.policy.module.apply(policy_params, jnp.asarray(obs))
        value, jvalue = model.critic(torch.tensor(obs)), jmodel.critic.apply(critic_params, jnp.asarray(obs))
    elif algorithm == "ppo_lstm":
        model.policy.load_state_dict(convert.recurrent_policy_state_dict(policy_params))
        model.critic.load_state_dict(convert.critic_state_dict(critic_params))
        policy = model.policy
        seq, dones = obs[:, None], np.zeros((B, 1), np.float32)
        ours = model.policy.sequence(torch.tensor(seq), torch.tensor(dones), model.policy.initialize_carry(1))[0]
        ref = jmodel.policy.apply(policy_params, jnp.asarray(seq), jnp.asarray(dones),
                                  jmodel.policy.initialize_carry(1), method=jmodel.policy.sequence)[0]
        value, jvalue = model.critic(torch.tensor(obs)), jmodel.critic.apply(critic_params, jnp.asarray(obs))
    else:  # reppo
        model.policy.load_state_dict(convert.reppo_policy_state_dict(policy_params))
        model.critic.load_state_dict(convert.reppo_critic_state_dict(critic_params))
        policy = model.policy
        ours, ref = model.policy(torch.tensor(obs)), jmodel.policy.apply(policy_params, jnp.asarray(obs))
        value = model.critic(torch.tensor(obs), torch.tensor(action))
        jvalue = jmodel.critic.apply(critic_params, jnp.asarray(obs), jnp.asarray(action))
    critic = model.critic
    return policy, critic, ours, ref, value, jvalue


def _off_policy(algorithm, jmodel, model, obs, action):
    import jax.numpy as jnp

    states = jmodel.states
    model.restore_from_tree(convert.checkpoint_tree_from_jax(algorithm, np_tree(jmodel.checkpoint_tree(states))))
    ours, ref = model.eval_act(torch.tensor(obs)), jmodel.eval_act(states, obs)
    critic_state = states["critic"]
    if algorithm in ("flashsac", "crossq"):
        variables = {"params": critic_state.params, "batch_stats": critic_state.batch_stats}
        jvalue = jmodel.critic.apply(variables, jnp.asarray(obs), jnp.asarray(action), False)
        value = model.critic.module(torch.tensor(obs), torch.tensor(action), False)
    else:
        jvalue = jmodel.critic.apply(critic_state.params, jnp.asarray(obs), jnp.asarray(action))
        value = model.critic.module(torch.tensor(obs), torch.tensor(action))
    return model.policy.module, model.critic.module, ours, ref, value, jvalue


@pytest.mark.parametrize("algorithm", list(SMALL))
def test_indices_select_the_columns_each_net_reads(algorithm):
    """Each net holds its index set, takes JAX's parameters, and a forward
    pass of each equals JAX's (1e-5)."""
    import jax

    jmodel, model = _models(algorithm)
    obs, action = _inputs(np.random.default_rng(len(algorithm)))
    run = _on_policy if algorithm in ("ppo", "ppo_lstm", "reppo") else _off_policy
    policy, critic, ours, ref, value, jvalue = run(algorithm, jmodel, model, obs, action)
    assert policy.observation_indices.tolist() == POLICY_INDICES
    assert critic.observation_indices.tolist() == CRITIC_INDICES
    ours = ours if isinstance(ours, (tuple, list)) else (ours,)
    ref = jax.tree.leaves(ref)
    value = value if isinstance(value, (tuple, list)) else (value,)
    jvalue = jax.tree.leaves(jvalue)
    for got, want in zip(ours, ref):
        close(got, np.broadcast_to(want, got.shape), 1e-5, f"{algorithm} policy")
    for got, want in zip(value, jvalue):
        close(got, want, 1e-5, f"{algorithm} critic")
