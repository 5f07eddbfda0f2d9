"""The port's PQN against the JAX package's, on CartPole on the CPU.  One
JAX learning iteration runs with its scans recorded: its rollout, its
Q(lambda) targets and its minibatch updates.  The port gets that rollout
and JAX's per-epoch permutations (drawn from the key the rollout leaves),
on converted parameters, and must give JAX's targets, metrics and updated
parameters.  The carts start near the track's ends so the rollout holds
terminations.  f32 on both sides; Adam's first steps move each weight by
~lr: 1e-5.  Then the sizing, epsilon and learning-rate schedules, and a
small train through the entry points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlx_tpu.environments.classic.cart_pole.tpu.environment import CartPolePhysics as JaxPhysics
from rlx_tpu_torch import convert
from rlx_tpu_torch.config import create_model, make_config
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

NR_ENVS, NR_STEPS, EPOCHS, MINIBATCHES = 4, 8, 2, 4
SMALL = {
    "environment.nr_envs": NR_ENVS,
    "algorithm.nr_steps": NR_STEPS,
    "algorithm.nr_epochs": EPOCHS,
    "algorithm.nr_minibatches": MINIBATCHES,
    "algorithm.critic_hidden_sizes": (32, 16),
    "algorithm.total_timesteps": 4 * NR_ENVS * NR_STEPS,
    "algorithm.max_grad_norm": 0.5,   # the clip acts
    "algorithm.evaluation_active": False,
}
SIZING = ("batch_size", "minibatch_size", "nr_updates", "eval_save_frequency", "nr_eval_save_iterations",
          "nr_updates_per_eval_save_iteration", "epsilon_decay_updates")
TOL = 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_model(overrides):
    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config

    return jax_create_model(jax_make_config("pqn.tpu", "classic.cart_pole.tpu", **overrides,
                                            **{"runner.mesh_dp": 1}))


def _close(ours, ref, what):
    np.testing.assert_allclose(np.asarray(ours, np.float32), np.asarray(ref, np.float32), rtol=TOL, atol=TOL,
                               err_msg=what)


def test_one_learning_iteration_matches_jax(monkeypatch):
    jmodel = _jax_model(SMALL)
    model = create_model(make_config("pqn.cuda", "classic.cart_pole.cuda", **SMALL, **{"runner.device": "cpu"}))
    to_torch = lambda params: convert.discrete_q_net_state_dict(_np_tree(params), layer_norm_all=True)
    model.q_net.load_state_dict(to_torch(jmodel.critic_state.params))

    scans, logged = [], []
    real_scan = jax.lax.scan

    def recording_scan(f, *args, **kwargs):   # traced under jit: record when the program runs
        out = real_scan(f, *args, **kwargs)
        jax.debug.callback(lambda values, name=f.__name__: scans.append((name, values)), out)
        return out

    monkeypatch.setattr(jax.lax, "scan", recording_scan)
    monkeypatch.setattr(jmodel, "_log_train_callback", lambda metrics, *_: logged.append(_np_tree(metrics)))
    env_state = jmodel.train_env.reset(jax.random.PRNGKey(1))
    x = np.array([2.3, -2.3, 0.0, 0.1], np.float32)
    env_state = env_state.replace(physics=JaxPhysics(jnp.asarray(x), jnp.asarray(np.sign(x)), jnp.zeros(4),
                                                     jnp.zeros(4)))
    env_state = env_state.replace(observation=jmodel.train_env.observe(env_state.physics))
    (critic_state, _, _), _ = jax.block_until_ready(jax.jit(jmodel._learning_iteration)(
        (jmodel.critic_state, env_state, jax.random.PRNGKey(2)), 1, 0))
    monkeypatch.undo()
    scans.sort(key=lambda s: ["single_rollout_step", "compute_q_targets", "minibatch_update"].index(s[0]))
    names = [name for name, _ in scans]
    assert names == ["single_rollout_step", "compute_q_targets", "minibatch_update"], names
    (_, _, key), (observations, final_observations, actions, rewards, terminations, _) = scans[0][1]
    assert np.asarray(terminations).any()
    _, perm_key = jax.random.split(key)
    batch_size = NR_ENVS * NR_STEPS
    epoch_indices = jax.random.permutation(perm_key, np.tile(np.arange(batch_size), (EPOCHS, 1)), axis=1,
                                           independent=True)
    batch = tuple(torch.tensor(np.asarray(v)) for v in (observations, final_observations, actions, rewards,
                                                         terminations))
    assert batch[2].dtype == torch.int32 and batch[4].dtype == torch.bool

    with torch.no_grad():
        next_values = model.q_net(batch[1].reshape(batch_size, -1)).max(dim=-1).values.reshape(NR_STEPS, NR_ENVS)
    _close(model.q_lambda_targets(batch[3], batch[4], next_values), scans[1][1][1], "Q(lambda) targets")

    metrics = model._learn(batch, torch.tensor(np.asarray(epoch_indices)))
    for name, ref in to_torch(critic_state.params).items():
        torch.testing.assert_close(model.q_net.state_dict()[name], ref, rtol=TOL, atol=TOL,
                                   msg=lambda m: f"{name}: {m}")
    (jmetrics,) = logged
    for k in ("loss/q_loss", "q_value/q_value", "gradients/critic_grad_norm", "lr/learning_rate"):
        _close(float(metrics[k]), float(jmetrics[k]), k)
    assert model.nr_optimizer_steps == EPOCHS * MINIBATCHES
    _close(model.epsilon(1), jmetrics["epsilon/epsilon"], "epsilon")


@pytest.mark.parametrize("anneal", [False, True])
def test_sizing_and_schedules_match_jax(anneal):
    overrides = {**SMALL, "algorithm.anneal_learning_rate": anneal, "algorithm.epsilon_decay_fraction": 0.5,
                 "algorithm.evaluation_and_save_frequency": 2 * NR_ENVS * NR_STEPS}
    jmodel = _jax_model(overrides)
    model = create_model(make_config("pqn.cuda", "classic.cart_pole.cuda", **overrides, **{"runner.device": "cpu"}))
    assert [getattr(model, k) for k in SIZING] == [getattr(jmodel, k) for k in SIZING]
    for step in range(4):
        _close(model.epsilon(step), jmodel.epsilon(step), f"epsilon at {step}")
    per_update = EPOCHS * MINIBATCHES
    expected = [2.5e-4 * (1.0 - k / 4) if anneal else 2.5e-4 for k in range(4)]
    assert [model.learning_rate_at(k * per_update + 1) for k in range(4)] == pytest.approx(expected)


def test_train_logs_evaluates_and_saves(tmp_path):
    overrides = {**SMALL, "algorithm.evaluation_active": True, "runner.save_model": True,
                 "algorithm.evaluation_and_save_frequency": 2 * NR_ENVS * NR_STEPS, "runner.device": "cpu"}
    model = create_model(make_config("pqn.cuda", "classic.cart_pole.cuda", **overrides), run_path=str(tmp_path))
    initial = [p.detach().clone() for p in model.q_net.parameters()]
    model.train()
    assert any(not torch.equal(a, b) for a, b in zip(initial, model.q_net.parameters()))
    assert [m["steps/nr_env_steps"] for m in model.metrics_history] == [32, 64, 96, 128]
    assert [m["steps/nr_updates"] for m in model.metrics_history] == [8, 16, 24, 32]
    assert all(np.isfinite(v) for m in model.metrics_history for v in m.values())
    assert list(model.eval_history["steps"]) == [64, 128]
    assert set(model.eval_history) == {"steps", "eval/episode_return", "eval/episode_length"}
    assert sorted(p.name for p in (tmp_path / "models").iterdir()) == ["latest.model"]
