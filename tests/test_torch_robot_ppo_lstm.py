"""One PPO-LSTM learning iteration of the port on its robot env against the
JAX package's ``_learning_iteration`` on its own, in float64 on both sides
(as ``test_torch_recurrent_ppo.py``: f32 Adam turns rounding-level
gradients into steps of the learning rate), from converted parameters.

The quadruped on its default heightfield, 4 envs, an 8-step window, with
JAX's action noise and minibatch permutations replayed from its key
chain.  The env's draws stay on each side: in training mode the
curriculum starts at 0, which scales every terrain, randomization, noise
and initial-state draw to nothing, and the command sampling is off, so
both envs run the same deterministic episodes.  Both nets, the carry
after the window, the observation and every metric agree at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rlx_tpu_torch import convert
from rlx_tpu_torch.config import create_env, create_model, make_config
from test_torch_recurrent_ppo import _jax_draws
from torch_parity import assert_state_dict, close, np_tree
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)
from torch_robot_parity import float64, to64  # noqa: F401 (module fixture: float64 on both sides)

E, T, EPOCHS, MINIBATCHES = 4, 8, 2, 2
TOL = 1e-5
OVERRIDES = {
    "environment.nr_envs": E, "environment.command.sampling_type": "none",
    "algorithm.nr_steps": T, "algorithm.nr_epochs": EPOCHS, "algorithm.nr_minibatches": MINIBATCHES,
    "algorithm.obs_encoding_dim": 8, "algorithm.rnn_hidden_dim": 8, "algorithm.critic_hidden_sizes": (16, 16),
    "algorithm.total_timesteps": E * T, "algorithm.learning_rate": 3e-3, "algorithm.entropy_coef": 0.01,
    "algorithm.evaluation_active": False, "algorithm.logging_active": True,
}


def test_learning_iteration_matches_jax(float64):
    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config

    jmodel = jax_create_model(jax_make_config("ppo_lstm.tpu", "locomotion.robot.tpu", **OVERRIDES,
                                              **{"runner.mesh_dp": 1}))
    config = make_config("ppo_lstm.cuda", "locomotion.robot.cuda", **OVERRIDES, **{"runner.device": "cpu"})
    env, _ = create_env(config)
    model = create_model(config, env, env)
    model.policy.load_state_dict(convert.recurrent_policy_state_dict(np_tree(jmodel.policy_state.params)))
    model.critic.load_state_dict(convert.critic_state_dict(np_tree(jmodel.critic_state.params)))
    assert model.critic.observation_indices.tolist() == list(range(61))
    assert model.policy.observation_indices.tolist() == np.asarray(jmodel.train_env.policy_observation_indices).tolist()
    logged = []
    jmodel._log_train_callback = lambda metrics, *_: logged.append({k: float(v) for k, v in metrics.items()})

    action_dim = env.nr_actuator_joints
    jreset = jax.jit(jmodel.train_env.reset)
    jcarry = (to64(jmodel.policy_state), to64(jmodel.critic_state), to64(jreset(jax.random.PRNGKey(0))),
              to64(jmodel.policy.initialize_carry(E)), jax.random.PRNGKey(5))
    noise, env_indices = _jax_draws(jcarry[4], action_dim)
    jcarry = jax.block_until_ready(jax.jit(lambda c: jmodel._learning_iteration(c, 0, 0)[0])(jcarry))
    jax.effects_barrier()

    env_state, carry = env.reset(0), model.policy.initialize_carry(E)
    env_state, carry, metrics = model.learning_iteration(env_state, carry, noise, env_indices)
    assert_state_dict(model.policy, convert.recurrent_policy_state_dict(np_tree(jcarry[0].params)), TOL, "policy")
    assert_state_dict(model.critic, convert.critic_state_dict(np_tree(jcarry[1].params)), TOL, "critic")
    for ours, ref in zip(jax.tree.leaves(carry), jax.tree.leaves(jcarry[3])):
        assert ours.dtype == torch.float64
        close(ours, ref, TOL, "carry after the window")
    close(env_state.observation, jcarry[2].observation, TOL, "observation")
    assert set(metrics) == set(logged[-1]), sorted(set(metrics) ^ set(logged[-1]))
    for k, v in logged[-1].items():
        close(float(metrics[k]), v, TOL, k)
    assert model.nr_optimizer_steps == int(jcarry[0].opt_state[1].count) == EPOCHS * MINIBATCHES
    assert float(jnp.abs(jcarry[2].reward).sum()) > 0.0
