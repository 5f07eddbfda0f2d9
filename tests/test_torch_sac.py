"""The port's SAC against the JAX package's:

- two consecutive ``update`` calls from converted parameters on the same
  batch, with JAX's normals replayed, against JAX ``SAC.update`` with and
  without ``anneal_learning_rate``: every metric, every parameter, the
  critic target and ``log_alpha`` after each call; part of the batch drives
  ``log_std`` past its clamp;
- ``act`` with JAX's exploration noise replayed, ``eval_act``, and the
  tanh-Gaussian sample and log-probability at |x| up to 20;
- ``train()`` on the Ant and on Pendulum with the JAX package's sizing, a
  JAX ``latest.model`` carried into the port, and a full-state save -> load
  after which one more update is equal bit for bit.
"""

import numpy as np
import pytest
import torch

from rlx_tpu_torch import convert
from rlx_tpu_torch.config import create_env, create_model, make_config
from rlx_tpu_torch.models import distributions as D
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

ACT, OBS, HIDDEN, B = 8, 34, (32, 16), 32
SMALL = {
    "environment.nr_envs": 8,
    "algorithm.batch_size": B,
    "algorithm.policy_hidden_sizes": HIDDEN,
    "algorithm.critic_hidden_sizes": HIDDEN,
    "algorithm.evaluation_active": False,
}
TRAIN = {
    "algorithm.total_timesteps": 320,
    "algorithm.learning_starts": 128,
    "algorithm.buffer_size": 2048,
    "algorithm.logging_frequency": 64,
}
SIZING = ("prefill_iterations", "nr_eval_save_iterations", "nr_loggings_per_eval_save_iteration",
          "nr_updates_per_logging_iteration", "capacity")


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _close(ours, ref, tol, what):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=tol, atol=tol, err_msg=what)


def _jax_model(environment, overrides):
    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config

    return jax_create_model(jax_make_config("sac.tpu", environment, **overrides, **{"runner.mesh_dp": 1}))


def _models(overrides=None):
    shared = {**SMALL, **(overrides or {})}
    jmodel = _jax_model("locomotion.ant.tpu", shared)
    model = create_model(make_config("sac.cuda", "locomotion.ant.cuda", **shared, **{"runner.device": "cpu"}))
    _load(model, jmodel.states)
    return jmodel, model


def _load(model, states):
    model.policy.module.load_state_dict(convert.squashed_gaussian_policy_state_dict(_np_tree(states["policy"].params)))
    model.critic.module.load_state_dict(convert.vector_q_critic_state_dict(_np_tree(states["critic"].params)))
    model.critic.target.load_state_dict(convert.vector_q_critic_state_dict(_np_tree(states["critic"].target_params)))
    model.alpha.module.load_state_dict(convert.entropy_coefficient_state_dict(_np_tree(states["alpha"].params)))


def _assert_states_match(model, states, tol, when):
    ours = {
        "policy": (model.policy.module, convert.squashed_gaussian_policy_state_dict, "policy", "params"),
        "critic": (model.critic.module, convert.vector_q_critic_state_dict, "critic", "params"),
        "critic target": (model.critic.target, convert.vector_q_critic_state_dict, "critic", "target_params"),
        "log_alpha": (model.alpha.module, convert.entropy_coefficient_state_dict, "alpha", "params"),
    }
    for what, (module, to_torch, name, field) in ours.items():
        ref = to_torch(_np_tree(getattr(states[name], field)))
        got = module.state_dict()
        assert set(got) == set(ref), what
        for key in ref:
            torch.testing.assert_close(got[key], ref[key], rtol=tol, atol=tol,
                                       msg=lambda m: f"{when}: {what} {key}: {m}")


def _batch(rng):
    obs = rng.normal(size=(B, OBS))
    # a quarter of the rows far out, so that log_std passes its clamp there
    obs[: B // 4] *= 40.0
    batch = {
        "observation": obs,
        "action": rng.uniform(-1, 1, size=(B, ACT)),
        "next_observation": rng.normal(size=(B, OBS)),
        "reward": rng.normal(size=B),
        "terminated": (rng.random(B) < 0.25).astype(np.float64),
        "truncated": np.zeros(B),
    }
    return {k: v.astype(np.float32) for k, v in batch.items()}


@pytest.mark.parametrize("anneal", [False, True])
def test_two_updates_match_jax(anneal):
    """Steps 0 and 1 on converted parameters, the same batches and JAX's
    target and current normals.  f32 on both sides, Adam's first steps move
    each weight by ~lr: 1e-5."""
    import jax

    jmodel, model = _models({"algorithm.anneal_learning_rate": anneal, "algorithm.total_timesteps": 320,
                             "algorithm.learning_starts": 64})
    states = jmodel.states
    _assert_states_match(model, states, 0.0, "converted")
    rng = np.random.default_rng(int(anneal))
    jupdate = jax.jit(jmodel.update)
    for step in (0, 1):
        batch = _batch(rng)
        with torch.no_grad():
            raw = model.policy.module.log_std(model.policy.module.trunk(torch.tensor(batch["observation"])))
        assert (raw > model.policy.module.log_std_max).any() or (raw < model.policy.module.log_std_min).any()
        key = jax.random.PRNGKey(20 + step)
        states, jmetrics = jupdate(states, batch, key, step)
        target_key, current_key = jax.random.split(key)
        noise = {name: torch.tensor(np.asarray(jax.random.normal(k, (B, ACT))))
                 for name, k in (("target_noise", target_key), ("current_noise", current_key))}
        metrics = model.update({k: torch.tensor(v) for k, v in batch.items()}, step, **noise)
        assert set(metrics) == set(jmetrics)
        for k in jmetrics:
            _close(float(metrics[k]), float(jmetrics[k]), 1e-5, f"step {step}: {k}")
        _assert_states_match(model, states, 1e-5, f"after step {step}")
    for state in (model.policy, model.critic, model.alpha):
        assert state.step_count() == 2
    assert int(states["policy"].opt_state.count) == 2
    if anneal:
        # the schedule's rate at count 1 (lr * (1 + (64 - 8) / 256))
        assert float(metrics["lr/learning_rate"]) == pytest.approx(3e-4 * (1 + 56 / 256), rel=1e-6)


def test_act_and_eval_act_match_jax():
    import jax

    jmodel, model = _models()
    rng = np.random.default_rng(5)
    obs = (3.0 * rng.normal(size=(8, OBS))).astype(np.float32)
    key = jax.random.PRNGKey(4)
    noise = torch.tensor(np.asarray(jax.random.normal(key, (8, ACT))))
    _close(model.act(torch.tensor(obs), noise=noise), jmodel.act(jmodel.states, obs, key, 0), 1e-5, "act")
    _close(model.eval_act(torch.tensor(obs)), jmodel.eval_act(jmodel.states, obs), 1e-5, "eval_act")


def test_tanh_gaussian_sample_and_log_prob_matches_jax():
    """Gaussians out to |x| = 20, where ``log(1 - tanh(x)^2)`` taken
    directly is ``log(0)``: the stable form on both sides, 1e-5."""
    import jax

    from rlx_tpu.models import distributions as jax_distributions

    rng = np.random.default_rng(3)
    mean = rng.uniform(-19.0, 19.0, size=(256, ACT)).astype(np.float32)
    logstd = rng.uniform(-3.0, 0.0, size=(256, ACT)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, mean.shape))
    assert np.abs(mean + np.exp(logstd) * noise).max() > 18.0
    action, log_prob = jax_distributions.tanh_gaussian_sample_and_log_prob(key, mean, logstd)
    ours_action, ours_log_prob = D.tanh_gaussian_sample_and_log_prob(
        torch.tensor(mean), torch.tensor(logstd), noise=torch.tensor(noise))
    _close(ours_action, action, 1e-5, "action")
    _close(ours_log_prob, log_prob, 1e-5, "log_prob")
    assert np.isfinite(ours_log_prob.numpy()).all()


@pytest.mark.parametrize("environment", ["locomotion.ant.cuda", "classic.pendulum.cuda"])
def test_sac_trains_with_the_jax_sizing(environment):
    overrides = {**SMALL, **TRAIN, "algorithm.evaluation_active": environment != "locomotion.ant.cuda"}
    model = create_model(make_config("sac.cuda", environment, **overrides, **{"runner.device": "cpu"}))
    jmodel = _jax_model("classic.pendulum.tpu", overrides)
    assert [getattr(model, k) for k in SIZING] == [getattr(jmodel, k) for k in SIZING]
    initial = [p.detach().clone() for p in model.policy.module.parameters()]
    model.train()
    assert any(not torch.equal(a, b) for a, b in zip(initial, model.policy.module.parameters()))
    for module in (model.policy.module, model.critic.module, model.critic.target, model.alpha.module):
        assert all(torch.isfinite(p).all() for p in module.parameters())
    # 16 prefill steps, then 24 learning steps in 3 log lines of 8
    assert model.prefill_iterations == 16
    assert [m["steps/nr_updates"] for m in model.metrics_history] == [8, 16, 24]
    assert all(np.isfinite(v) for m in model.metrics_history for v in m.values())
    if model.eval_history is not None:
        assert list(model.eval_history["steps"]) == [320]
        assert np.isfinite(model.eval_history["eval/episode_return"]).all()


def test_jax_checkpoint_carries_into_the_port(tmp_path):
    """The key set of a JAX ``latest.model`` is the port's, and its
    parameters give the port JAX's ``eval_act``."""
    import jax

    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config
    from rlx_tpu.utils.checkpoint import load_model_file

    jmodel = jax_create_model(jax_make_config("sac.tpu", "classic.pendulum.tpu", **SMALL, **{
        "runner.mesh_dp": 1, "runner.save_model": True}), run_path=str(tmp_path / "jax"))
    states = jmodel.states
    jmodel.states = {
        **states,
        "critic": states["critic"].replace(target_params=jax.tree.map(lambda x: -x, states["critic"].params)),
        "alpha": states["alpha"].replace(params=jax.tree.map(lambda x: x - 0.5, states["alpha"].params)),
    }
    jmodel.save()
    restored, _ = load_model_file(str(tmp_path / "jax" / "models" / "latest.model"))
    port = create_model(make_config("sac.cuda", "classic.pendulum.cuda", **SMALL, **{"runner.device": "cpu"}))
    assert set(port.checkpoint_tree()) == set(restored) == {"policy", "critic", "critic_target", "alpha"}
    port.restore_from_tree(convert.checkpoint_tree_from_jax("sac", _np_tree(restored)))
    _assert_states_match(port, jmodel.states, 1e-6, "restored")
    obs = (3.0 * np.random.default_rng(2).normal(size=(64, 3))).astype(np.float32)
    _close(port.eval_act(torch.tensor(obs)), jmodel.eval_act(jmodel.states, obs), 1e-6, "eval_act")


def test_full_state_round_trip_then_one_more_update(tmp_path):
    """Saved with the optimizers' state and loaded: every tensor and the
    update count equal, and one more update on the same batch and noise
    equal bit for bit to the model that never saved."""
    from rlx_tpu_torch.algorithms.sac.cuda.sac import SAC

    overrides = {**SMALL, **TRAIN, "runner.device": "cpu", "environment.nr_envs": 4,
                 "algorithm.total_timesteps": 160, "runner.save_optimizer_state": True,
                 "algorithm.logging_active": False}
    model = create_model(make_config("sac.cuda", "classic.pendulum.cuda", **overrides, **{
        "runner.save_model": True}), run_path=str(tmp_path / "run"))
    model.train()
    config = make_config("sac.cuda", "classic.pendulum.cuda", **overrides, **{
        "runner.load_model": str(tmp_path / "run" / "models" / "latest.model")})
    loaded = SAC.load(config, *create_env(config), str(tmp_path / "loaded"), None, [])
    assert loaded.nr_updates == model.nr_updates == 16
    full = model.checkpoint_tree()["full"]
    assert set(full) == {"policy", "critic", "alpha", "nr_updates"}
    assert "target_params" not in full["policy"] and "target_params" in full["critic"]
    assert _same_tree(full, loaded.checkpoint_tree()["full"]) > 0
    rng = np.random.default_rng(4)
    batch = {k: torch.tensor(v[:, :3] if k.endswith("observation") else v[:, :1] if k == "action" else v)
             for k, v in _batch(rng).items()}
    noise = {k: torch.tensor(rng.normal(size=(B, 1)).astype(np.float32)) for k in ("target_noise", "current_noise")}
    for m in (model, loaded):
        m.update(batch, 0, **noise)
    assert _same_tree(model.checkpoint_tree(), loaded.checkpoint_tree()) > 0


def _same_tree(a, b):
    """The number of tensors, asserting every one equal bit for bit and
    every other leaf equal."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        return sum(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        return sum(_same_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
        return 1
    assert a == b
    return 0


def test_left_out_features_raise():
    with pytest.raises(KeyError):
        make_config("sac.cuda", "classic.pendulum.cuda", **{"algorithm.shard_local_sampling": False})
    # parallel seeds are ported: the key is there
    assert make_config("sac.cuda", "classic.pendulum.cuda", **{"algorithm.nr_parallel_seeds": 2}
                       ).algorithm.nr_parallel_seeds == 2
