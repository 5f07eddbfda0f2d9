"""The port's PPO against the JAX package's: one ``_optimize`` call from
converted parameters on a fixed batch, with JAX's own epoch permutations
injected; plus a tiny end-to-end CPU train through the runner, and the
config/registry contract."""

import jax
import numpy as np
import pytest
import torch

from rlx_tpu.config import create_model as jax_create_model
from rlx_tpu.config import make_config as jax_make_config
from rlx_tpu_torch import convert
from rlx_tpu_torch.algorithms.train_state import clip_by_global_norm_
from rlx_tpu_torch.config import create_model, make_config
from rlx_tpu_torch.runner.runner import Runner, parse_flags

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


def test_optimize_matches_jax():
    jmodel = jax_create_model(jax_make_config("ppo.tpu", "locomotion.ant.tpu", **SHARED, **{
        "runner.mesh_dp": 1, "algorithm.evaluation_active": False,
    }))
    model = create_model(make_config("ppo.cuda", "locomotion.ant.cuda", **SHARED, **{
        "runner.device": "cpu",
    }))
    model.policy.module.load_state_dict(convert.policy_state_dict(_np_tree(jmodel.policy_state.params)))
    model.critic.load_state_dict(convert.critic_state_dict(_np_tree(jmodel.critic_state.params)))

    N = NR_ENVS * NR_STEPS
    rng = np.random.default_rng(0)
    batch = (
        rng.normal(size=(N, 34)).astype(np.float32),
        rng.normal(size=(N, 8)).astype(np.float32),
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
    for name, ref in convert.policy_state_dict(_np_tree(policy_state.params)).items():
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


def test_tiny_train_through_runner():
    """8 envs x 8 steps, 2 iterations, plain kernels on the CPU."""
    model = Runner([
        "--runner.device=cpu", "--environment.nr_envs=8", "--algorithm.nr_steps=8",
        "--algorithm.minibatch_size=16", "--algorithm.nr_epochs=2",
        "--algorithm.total_timesteps=128", "--algorithm.policy_hidden_sizes=(32, 32)",
        "--algorithm.critic_hidden_sizes=(32, 32)", "--algorithm.activation=elu",
        "--algorithm.layer_norm=True", "--algorithm.compute_dtype=bfloat16",
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
    assert parse_flags(["--a.b=3", "--c.d", "x", "--e.f=(1, 2)"]) == {"a.b": 3, "c.d": "x", "e.f": (1, 2)}
    with pytest.raises(NotImplementedError):
        Runner(["--runner.mode=test", "--runner.device=cpu"]).run()
