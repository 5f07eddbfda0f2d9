"""The port's PPO against the JAX package's: one ``_optimize`` call from
converted parameters on a fixed batch, with JAX's own epoch permutations
injected; the eval/save sizing and the eval history's step axis and keys;
plus a tiny end-to-end CPU train through the runner, the best-model
checkpoint, evaluation leaving training as it was, and the config/registry
contract."""

import os

import jax
import numpy as np
import pytest
import torch

from rlx_tpu.config import create_model as jax_create_model
from rlx_tpu.config import make_config as jax_make_config
from rlx_tpu_torch import convert
from rlx_tpu_torch.algorithms.train_state import clip_by_global_norm_
from rlx_tpu_torch.config import create_env, create_model, make_config
from rlx_tpu_torch.runner.runner import Runner, parse_flags
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

NR_ENVS, NR_STEPS, MINIBATCH, EPOCHS = 4, 4, 8, 2
SHARED = {
    "environment.nr_envs": NR_ENVS,
    "algorithm.nr_steps": NR_STEPS,
    "algorithm.minibatch_size": MINIBATCH,
    "algorithm.nr_epochs": EPOCHS,
    "algorithm.total_timesteps": 2 * NR_ENVS * NR_STEPS,
    "algorithm.policy_hidden_sizes": (16, 16),
    "algorithm.critic_hidden_sizes": (16, 16),
    "algorithm.activation": "elu",
    "algorithm.layer_norm": True,
    "algorithm.entropy_coef": 0.01,
    "algorithm.logging_active": False,
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _optimize_matches_jax(environment, obs_dim, actions, policy_state_dict):
    """One ``_optimize`` call of the port and of JAX from the same converted
    parameters, batch and epoch permutations (JAX's own, drawn from its key)."""
    jmodel = jax_create_model(jax_make_config("ppo.tpu", f"{environment}.tpu", **SHARED, **{
        "runner.mesh_dp": 1, "algorithm.evaluation_active": False,
    }))
    model = create_model(make_config("ppo.cuda", f"{environment}.cuda", **SHARED, **{
        "runner.device": "cpu",
    }))
    model.policy.module.load_state_dict(policy_state_dict(_np_tree(jmodel.policy_state.params)))
    model.critic.load_state_dict(convert.critic_state_dict(_np_tree(jmodel.critic_state.params)))

    N = NR_ENVS * NR_STEPS
    rng = np.random.default_rng(0)
    batch = (
        rng.normal(size=(N, obs_dim)).astype(np.float32),
        actions(rng, N),
        rng.normal(size=N).astype(np.float32) - 8.0,
        rng.normal(size=N).astype(np.float32),
        rng.normal(size=N).astype(np.float32),
    )
    key = jax.random.PRNGKey(7)
    # the permutation JAX's _optimize draws from this key
    _, perm_key = jax.random.split(key)
    epoch_indices = jax.random.permutation(
        perm_key, np.tile(np.arange(N), (EPOCHS, 1)), axis=1, independent=True
    )
    policy_state, critic_state, jmetrics = jmodel._optimize(
        jmodel.policy_state, jmodel.critic_state, batch, key
    )
    metrics = model._optimize(tuple(torch.tensor(x) for x in batch),
                              epoch_indices=torch.tensor(np.asarray(epoch_indices)))

    # f32 on both sides; Adam's first steps move each weight by ~lr, so the
    # parameters are compared at 1e-5 absolute
    for name, ref in policy_state_dict(_np_tree(policy_state.params)).items():
        torch.testing.assert_close(model.policy.module.state_dict()[name], ref, rtol=1e-5, atol=1e-5,
                                   msg=lambda m: f"policy {name}: {m}")
    for name, ref in convert.critic_state_dict(_np_tree(critic_state.params)).items():
        torch.testing.assert_close(model.critic.state_dict()[name], ref, rtol=1e-5, atol=1e-5,
                                   msg=lambda m: f"critic {name}: {m}")
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert model.nr_optimizer_steps == EPOCHS * N // MINIBATCH


def test_optimize_matches_jax():
    _optimize_matches_jax("locomotion.ant", 34, lambda rng, n: rng.normal(size=(n, 8)).astype(np.float32),
                          convert.policy_state_dict)


def test_discrete_optimize_matches_jax():
    """CartPole's int32 actions ``[N]`` travel through the packed minibatch
    as one f32 column and come back as they were."""
    _optimize_matches_jax("classic.cart_pole", 4, lambda rng, n: rng.integers(0, 2, size=n).astype(np.int32),
                          convert.categorical_policy_state_dict)


def test_discrete_rollout_and_modes():
    """Discrete PPO on CartPole: int32 actions ``[T, N]`` in the rollout, the
    deterministic action is the argmax of the logits, the env takes the
    actions as they are, and a learning iteration ends finite."""
    model = create_model(make_config("ppo.cuda", "classic.cart_pole.cuda", **SHARED, **{"runner.device": "cpu"}))
    obs = torch.tensor(np.random.default_rng(1).normal(size=(5, 4)).astype(np.float32))
    assert torch.equal(model.policy.mode(obs), torch.argmax(model.policy.module(obs), dim=-1).to(torch.int32))
    action = torch.tensor([0, 1, 1], dtype=torch.int32)
    assert model.policy.process_action(action) is action
    _, batch, _ = model._rollout(model.train_env.reset(0))
    assert batch[2].dtype == torch.int32 and batch[2].shape == (NR_STEPS, NR_ENVS)
    env_state, metrics = model.learning_iteration(model.train_env.reset(0))
    assert "policy/std_dev" not in metrics and all(torch.isfinite(v) for v in metrics.values())


def test_clip_by_global_norm_matches_optax():
    import optax

    rng = np.random.default_rng(1)
    grads = [rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=5).astype(np.float32)]
    for max_norm in (0.5, 100.0):
        ref, _ = optax.clip_by_global_norm(max_norm).update(grads, optax.EmptyState())
        ours = [torch.tensor(g) for g in grads]
        norm = clip_by_global_norm_(ours, max_norm)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        for o, r in zip(ours, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)


def test_learning_rate_schedule():
    """Linear anneal on the optimizer step count, stepped once per learning
    iteration (``ppo.py``'s ``linear_schedule`` in the JAX package)."""
    model = create_model(make_config("ppo.cuda", "locomotion.ant.cuda", **{
        **SHARED, "runner.device": "cpu", "algorithm.total_timesteps": 4 * NR_ENVS * NR_STEPS,
    }))
    per_update = model.nr_minibatches * model.nr_epochs
    assert model.learning_rate_at(0) == pytest.approx(3e-4)
    assert model.learning_rate_at(per_update - 1) == pytest.approx(3e-4)
    assert model.learning_rate_at(per_update) == pytest.approx(3e-4 * 0.75)
    assert model.learning_rate_at(3 * per_update) == pytest.approx(3e-4 * 0.25)


def test_tiny_train_through_runner(tmp_path, monkeypatch):
    """8 envs x 8 steps, 2 iterations, plain kernels on the CPU."""
    monkeypatch.chdir(tmp_path)
    model = Runner([
        "--runner.device=cpu", "--environment.nr_envs=8", "--algorithm.nr_steps=8",
        "--algorithm.minibatch_size=16", "--algorithm.nr_epochs=2",
        "--algorithm.total_timesteps=128", "--algorithm.policy_hidden_sizes=(32, 32)",
        "--algorithm.critic_hidden_sizes=(32, 32)", "--algorithm.activation=elu",
        "--algorithm.layer_norm=True", "--algorithm.compute_dtype=bfloat16",
        "--algorithm.evaluation_active=False",
    ]).run()
    assert len(model.metrics_history) == 2
    for metrics in model.metrics_history:
        for k in ("loss/policy_gradient_loss", "loss/critic_loss", "loss/entropy_loss", "time/sps"):
            assert np.isfinite(metrics[k]), k
    assert metrics["steps/nr_env_steps"] == 128
    assert model.nr_optimizer_steps == 2 * 2 * 4
    for p in model.policy.module.parameters():
        assert torch.isfinite(p).all()


def test_config_overrides_and_registries():
    config = make_config("ppo.cuda", "locomotion.ant.cuda", **{"algorithm.nr_steps": 64})
    assert config.algorithm.name == "ppo.cuda" and config.environment.name == "locomotion.ant.cuda"
    assert config.algorithm.nr_steps == 64 and config.runner.device == "cuda"
    assert config.to_dict()["algorithm"]["nr_steps"] == 64
    with pytest.raises(KeyError):
        make_config("ppo.cuda", "locomotion.ant.cuda", **{"algorithm.nr_stepz": 64})
    # the command line's text, cast to each field's type when the config is made
    assert parse_flags(["--a.b=3", "--c.d", "x", "--e.f=(1, 2)"]) == {"a.b": "3", "c.d": "x", "e.f": "(1, 2)"}
    flagged = make_config("ppo.cuda", "locomotion.ant.cuda", **parse_flags([
        "--algorithm.nr_steps=3", "--algorithm.activation", "x", "--algorithm.policy_hidden_sizes=(1, 2)"]))
    assert (flagged.algorithm.nr_steps, flagged.algorithm.activation,
            flagged.algorithm.policy_hidden_sizes) == (3, "x", (1, 2))
    with pytest.raises(ValueError, match="Unknown runner mode"):
        Runner(["--runner.mode=bogus", "--runner.device=cpu"]).run()


PENDULUM = {
    "runner.device": "cpu",
    "environment.nr_envs": 4,
    "algorithm.nr_steps": 8,
    "algorithm.minibatch_size": 16,
    "algorithm.nr_epochs": 2,
    "algorithm.policy_hidden_sizes": (16, 16),
    "algorithm.critic_hidden_sizes": (16, 16),
    "algorithm.logging_active": False,
}
BATCH = 4 * 8


@pytest.mark.parametrize("total,frequency", [
    (2 * BATCH, -1), (3 * BATCH, BATCH), (5 * BATCH, 2 * BATCH), (2 * BATCH, 3 * BATCH), (4 * BATCH, 20),
])
def test_eval_save_sizing_and_history_match_jax(total, frequency):
    """``nr_eval_save_iterations``, ``nr_updates_per_eval_save_iteration``,
    the history's steps and its eval keys equal JAX ``PPO``'s; a frequency
    that is not a multiple of the batch raises in both."""
    shared = {k: v for k, v in PENDULUM.items() if k != "runner.device"}
    shared.update({"algorithm.total_timesteps": total, "algorithm.evaluation_and_save_frequency": frequency,
                   "environment.horizon": 16})
    jax_config = jax_make_config("ppo.tpu", "classic.pendulum.tpu", **shared, **{"runner.mesh_dp": 1})
    config = make_config("ppo.cuda", "classic.pendulum.cuda", **shared, **{"runner.device": "cpu"})
    if frequency != -1 and frequency % BATCH != 0:
        for make in (lambda: jax_create_model(jax_config), lambda: create_model(config)):
            with pytest.raises(ValueError, match="multiple"):
                make()
        return
    jmodel, model = jax_create_model(jax_config), create_model(config)
    for attribute in ("nr_updates", "eval_save_frequency", "nr_eval_save_iterations",
                      "nr_updates_per_eval_save_iteration"):
        assert getattr(model, attribute) == getattr(jmodel, attribute), attribute
    jmodel.train()
    model.train()
    assert set(model.eval_history) == set(jmodel.eval_history)
    np.testing.assert_array_equal(model.eval_history["steps"], jmodel.eval_history["steps"])
    assert model.nr_optimizer_steps == (model.nr_eval_save_iterations * model.nr_updates_per_eval_save_iteration
                                        * model.nr_minibatches * model.nr_epochs)
    assert len(model.eval_history["eval/episode_return"]) == model.nr_eval_save_iterations


def test_best_model_written_iff_an_eval_improved(tmp_path):
    """latest.model after every eval/save iteration, best.model when the eval
    return beats the best so far (scripted returns -5, -7, -3)."""
    model = create_model(make_config("ppo.cuda", "classic.pendulum.cuda", **{
        **PENDULUM, "runner.save_model": True, "algorithm.total_timesteps": 3 * BATCH,
        "algorithm.evaluation_and_save_frequency": BATCH,
    }), run_path=str(tmp_path))
    scripted = iter([-5.0, -7.0, -3.0])
    model._eval_iteration = lambda i: {"eval/episode_return": next(scripted)}
    saves = []
    save = model.save
    model.save = lambda file_name="latest.model": (saves.append(file_name), save(file_name))
    model.train()
    assert saves == ["latest.model", "best.model", "latest.model", "latest.model", "best.model"]
    assert sorted(os.listdir(tmp_path / "models")) == ["best.model", "latest.model"]

    quiet = create_model(make_config("ppo.cuda", "classic.pendulum.cuda", **{
        **PENDULUM, "runner.save_model": True, "algorithm.total_timesteps": BATCH,
        "algorithm.evaluation_active": False,
    }), run_path=str(tmp_path / "quiet"))
    quiet.train()
    assert sorted(os.listdir(tmp_path / "quiet" / "models")) == ["latest.model"]


def test_evaluation_leaves_training_as_it_was():
    """With the train env as the eval env (the Ant's
    ``copy_train_env_for_eval``), an evaluation leaves ``env_state`` and the
    train generator as they were, and the next learning iteration equals one
    that followed no evaluation, bit for bit."""
    config = make_config("ppo.cuda", "classic.pendulum.cuda", **{**PENDULUM, "algorithm.total_timesteps": BATCH})
    models = []
    for evaluate in (False, True):
        train_env = create_env(config)[0]
        model = create_model(config, train_env, train_env)
        env_state, _ = model._init_train_carry()
        if evaluate:
            before = (env_state.observation.clone(), [t.clone() for t in env_state.physics],
                      env_state.generator.get_state(), model.generator.get_state())
            model._eval_iteration(0)
            assert model.env_state is env_state
            assert torch.equal(env_state.observation, before[0])
            assert all(torch.equal(a, b) for a, b in zip(env_state.physics, before[1]))
            assert torch.equal(env_state.generator.get_state(), before[2])
            assert torch.equal(model.generator.get_state(), before[3])
        model.env_state, _ = model.learning_iteration(env_state)
        models.append(model)
    for a, b in zip(models[0].policy.module.parameters(), models[1].policy.module.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(models[0].env_state.observation, models[1].env_state.observation)
