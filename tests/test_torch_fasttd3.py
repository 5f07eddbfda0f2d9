"""The port's FastTD3 against the JAX package's:

- two consecutive ``update`` calls (step 0 steps the policy, step 1 does
  not) from converted parameters on the same batch, with JAX's smoothing
  noise replayed, against JAX ``FastTD3.update``: losses, every parameter,
  target parameter and normalizer leaf after each call;
- ``act`` with JAX's exploration noise replayed;
- the whole slice through ``make_config`` / ``create_model`` / ``train()``
  on the CPU (Ant and Pendulum), with the best-model checkpoint and test
  mode.
"""

import os

import numpy as np
import pytest
import torch

from rlx_tpu_torch import convert
from rlx_tpu_torch.config import create_model, make_config
from rlx_tpu_torch.runner.runner import Runner
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

ACT, ATOMS = 8, 11
OBS, HIDDEN = 34, (32, 16)
SMALL = {
    "environment.nr_envs": 8,
    "algorithm.batch_size": 32,
    "algorithm.nr_atoms": ATOMS,
    "algorithm.policy_hidden_sizes": HIDDEN,
    "algorithm.critic_hidden_sizes": HIDDEN,
}


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _close(ours, ref, tol, what):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol, err_msg=what)


def _models(n_step, clipped_double_q):
    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config

    shared = {**SMALL, "algorithm.n_step": n_step, "algorithm.clipped_double_q_learning": clipped_double_q,
              "algorithm.evaluation_active": False}
    jmodel = jax_create_model(jax_make_config("fasttd3.tpu", "locomotion.ant.tpu", **shared,
                                              **{"runner.mesh_dp": 1}))
    model = create_model(make_config("fasttd3.cuda", "locomotion.ant.cuda", **shared,
                                     **{"runner.device": "cpu"}))
    return jmodel, model


def _load(model, states):
    policy, critic = states["policy"], states["critic"]
    to_policy, to_critic = convert.deterministic_policy_state_dict, convert.vector_q_critic_state_dict
    model.policy.module.load_state_dict(to_policy(_np_tree(policy.params)))
    model.policy.target.load_state_dict(to_policy(_np_tree(policy.target_params)))
    model.critic.module.load_state_dict(to_critic(_np_tree(critic.params)))
    model.critic.target.load_state_dict(to_critic(_np_tree(critic.target_params)))
    model.obs_normalizer = {k: torch.tensor(np.asarray(v)) for k, v in states["obs_normalizer"].items()}


def _batch(n_step, rng, B=32):
    batch = {
        "observation": rng.normal(size=(B, OBS)),
        "action": rng.uniform(-1, 1, size=(B, ACT)),
    }
    if n_step > 1:
        batch.update({
            "n_step_next_observation": rng.normal(size=(B, OBS)),
            "n_step_reward": rng.normal(size=B),
            "n_step_terminated": (rng.random(B) < 0.25).astype(np.float64),
            "n_step_gamma": 0.97 ** rng.integers(1, n_step + 1, size=B),
        })
    else:
        batch.update({
            "next_observation": rng.normal(size=(B, OBS)),
            "reward": rng.normal(size=B),
            "terminated": (rng.random(B) < 0.25).astype(np.float64),
            "truncated": np.zeros(B),
        })
    return {k: v.astype(np.float32) for k, v in batch.items()}


def _assert_states_match(model, states, tol, when):
    ours = {
        "policy": (model.policy.module, convert.deterministic_policy_state_dict, "params"),
        "policy target": (model.policy.target, convert.deterministic_policy_state_dict, "target_params"),
        "critic": (model.critic.module, convert.vector_q_critic_state_dict, "params"),
        "critic target": (model.critic.target, convert.vector_q_critic_state_dict, "target_params"),
    }
    for what, (module, to_torch, field) in ours.items():
        state = states[what.split()[0]]
        ref = to_torch(_np_tree(getattr(state, field)))
        got = module.state_dict()
        assert set(got) == set(ref), what
        for name in ref:
            torch.testing.assert_close(got[name], ref[name], rtol=tol, atol=tol,
                                       msg=lambda m: f"{when}: {what} {name}: {m}")
    for k, v in states["obs_normalizer"].items():
        _close(model.obs_normalizer[k], v, tol, f"{when}: obs_normalizer {k}")


@pytest.mark.parametrize("n_step,clipped_double_q", [(1, True), (3, True), (3, False)])
def test_two_updates_match_jax(n_step, clipped_double_q):
    """Step 0 (critic, policy, both targets) then step 1 (critic only), on
    converted parameters, the same batch and JAX's smoothing noise.  f32 on
    both sides, AdamW's first steps move each weight by ~lr: 1e-5."""
    import jax

    jmodel, model = _models(n_step, clipped_double_q)
    states = jmodel.states
    # a normalizer that has seen data, so that normalization is exercised
    rng = np.random.default_rng(n_step)
    from rlx_tpu.ops import normalizers as jax_normalizers

    states = {**states, "obs_normalizer": jax_normalizers.obs_normalizer_update(
        states["obs_normalizer"], (2.0 * rng.normal(size=(64, OBS)) + 0.5).astype(np.float32))}
    _load(model, states)
    _assert_states_match(model, states, 0.0, "converted")

    jupdate = jax.jit(jmodel.update)
    for step in (0, 1):
        batch = _batch(n_step, rng)
        key = jax.random.PRNGKey(10 + step)
        states, jmetrics = jupdate(states, batch, key, step)
        # FastTD3.update draws its smoothing noise from the update key itself
        noise = jax.random.normal(key, (32, ACT))
        metrics = model.update({k: torch.tensor(v) for k, v in batch.items()}, step,
                               smoothing_noise=torch.tensor(np.asarray(noise)))
        assert set(metrics) == set(jmetrics)
        for k in jmetrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {step}: {k}")
        _assert_states_match(model, states, 1e-5, f"after step {step}")
    # the policy's Adam took one step, the critic's two
    assert model.policy.optimizer.state[next(model.policy.module.parameters())]["step"] == 1
    assert model.critic.optimizer.state[next(model.critic.module.parameters())]["step"] == 2
    assert int(states["policy"].opt_state.inner_state[0].count) == 1


def test_act_matches_jax():
    """Per-env noise scales on JAX's own draws, clipped to [-1, 1]."""
    import jax

    jmodel, model = _models(1, True)
    _load(model, jmodel.states)
    rng = np.random.default_rng(5)
    obs = (3.0 * rng.normal(size=(8, OBS))).astype(np.float32)
    key = jax.random.PRNGKey(4)
    expected = jmodel.act(jmodel.states, obs, key, 0)
    noise = jax.random.normal(key, (8, ACT))
    action = model.act(torch.tensor(obs), noise=torch.tensor(np.asarray(noise)))
    _close(action, expected, 1e-5, "act")
    _close(model.eval_act(torch.tensor(obs)), jmodel.eval_act(jmodel.states, obs), 1e-5, "eval_act")
    np.testing.assert_allclose(model.noise_scales.numpy(), np.asarray(jmodel.noise_scales), rtol=1e-6)
    np.testing.assert_allclose(model.atoms.numpy(), np.asarray(jmodel.atoms), rtol=0, atol=1e-6)


def _train(environment, n_step, **extra):
    config = make_config("fasttd3.cuda", environment, **{
        **SMALL,
        "runner.device": "cpu",
        "algorithm.total_timesteps": 320,
        "algorithm.learning_starts": 128,
        "algorithm.buffer_size": 2048,
        "algorithm.n_step": n_step,
        "algorithm.logging_frequency": 64,
        "algorithm.policy_hidden_sizes": (32, 32),
        "algorithm.critic_hidden_sizes": (32, 32),
        **extra,
    })
    model = create_model(config)
    initial = [p.detach().clone() for p in model.policy.module.parameters()]
    model.train()
    changed = [not torch.allclose(a, b) for a, b in zip(initial, model.policy.module.parameters())]
    assert any(changed)
    for state in (model.policy, model.critic):
        for module in (state.module, state.target):
            for p in module.parameters():
                assert torch.isfinite(p).all()
    for v in model.obs_normalizer.values():
        assert torch.isfinite(v).all()
    # the normalizer saw the 24 learning steps (192 observations), not the prefill
    assert float(model.obs_normalizer["count"]) == pytest.approx(192, abs=1e-2)
    # 16 prefill steps, then 24 learning steps in 3 log lines of 8
    assert model.prefill_iterations == 16
    assert [m["steps/nr_updates"] for m in model.metrics_history] == [8, 16, 24]
    for m in model.metrics_history:
        for k in ("loss/q_loss", "loss/policy_loss", "q_value/q_value"):
            assert np.isfinite(m[k]), k
    return model


@pytest.mark.parametrize("n_step", [1, 3])
def test_fasttd3_trains_on_the_ant(n_step):
    _train("locomotion.ant.cuda", n_step, **{"algorithm.evaluation_active": False})


def test_fasttd3_trains_and_evaluates_on_pendulum():
    model = _train("classic.pendulum.cuda", 3)
    assert model.nr_eval_save_iterations == 1
    assert list(model.eval_history["steps"]) == [320]
    assert model.eval_history["eval/episode_length"][0] == 200.0
    assert np.isfinite(model.eval_history["eval/episode_return"]).all()


def test_runner_trains_fasttd3(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    model = Runner([
        "--algorithm.name=fasttd3.cuda", "--environment.name=classic.pendulum.cuda",
        "--runner.device=cpu", "--algorithm.total_timesteps=96", "--algorithm.learning_starts=32",
        "--algorithm.batch_size=16", "--algorithm.logging_frequency=32",
        "--algorithm.policy_hidden_sizes=(16, 16)", "--algorithm.critic_hidden_sizes=(16, 16)",
        "--algorithm.nr_atoms=11", "--algorithm.evaluation_active=False",
    ]).run()
    assert [m["steps/nr_env_steps"] for m in model.metrics_history] == [32, 64]


def test_left_out_features_raise():
    for key, value in (("anneal_learning_rate", True), ("learning_starts_per_env", 8), ("buffer_size_per_env", 256)):
        with pytest.raises(KeyError):
            make_config("fasttd3.cuda", "locomotion.ant.cuda", **{f"algorithm.{key}": value})
    # parallel seeds are ported: the key is there
    assert make_config("fasttd3.cuda", "locomotion.ant.cuda", **{"algorithm.nr_parallel_seeds": 2}
                       ).algorithm.nr_parallel_seeds == 2
    # the velocity-masked Pendulum is ported: FastTD3 sees its 2 channels
    masked = create_model(make_config("fasttd3.cuda", "classic.pendulum.cuda", **{
        "runner.device": "cpu", "environment.mask_velocity": True}))
    assert masked.os_shape == (2,)


def test_best_model_written_iff_an_eval_improved_and_test_mode(tmp_path):
    """latest.model after every eval/save iteration, best.model when the eval
    return beats the best so far (scripted returns -5, -3, -4); then test
    mode collects finite returns and the update count covers every step."""
    config = make_config("fasttd3.cuda", "classic.pendulum.cuda", **{
        **SMALL, "runner.device": "cpu", "runner.save_model": True, "algorithm.total_timesteps": 80,
        "algorithm.learning_starts": 32, "algorithm.buffer_size": 256, "algorithm.logging_frequency": 16,
        "algorithm.evaluation_and_save_frequency": 16, "environment.nr_envs": 4,
    })
    model = create_model(config, run_path=str(tmp_path))
    scripted = iter([-5.0, -3.0, -4.0])
    model._eval_iteration = lambda i: {"eval/episode_return": next(scripted)}
    saves = []
    save = model.save
    model.save = lambda file_name="latest.model": (saves.append(file_name), save(file_name))
    model.train()
    assert saves == ["latest.model", "best.model", "latest.model", "best.model", "latest.model"]
    assert sorted(os.listdir(tmp_path / "models")) == ["best.model", "latest.model"]
    assert model.nr_updates == 3 * 4
    np.testing.assert_array_equal(model.eval_history["steps"], [48, 64, 80])
    returns = model.test(3)
    assert len(returns) == 3 and all(np.isfinite(returns))
