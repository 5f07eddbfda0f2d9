"""The port's FastSAC against the JAX package's:

- two consecutive ``update`` calls from converted parameters and a
  non-trivial observation normalizer, with JAX's target and current
  normals replayed, at ``n_step`` 1 and 3: every metric, parameter, target,
  ``log_alpha`` after each call (1e-5);
- the entropy-shifted target projected by the plain version of kernel B3
  against the JAX package's projection, at Pendulum's support and at the
  defaults' (1e-5);
- ``train()`` through the entry points on Pendulum and a JAX
  ``latest.model`` carried into the port.
"""

import numpy as np
import pytest
import torch

from rlx_tpu_torch import convert
from rlx_tpu_torch.config import create_model, make_config
from torch_parity import assert_state_dict, batch, close, models, normals, np_tree, to_torch
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

ACT, OBS, ATOMS, B = 8, 34, 11, 32
SMALL = {
    "environment.nr_envs": 8,
    "algorithm.batch_size": B,
    "algorithm.nr_atoms": ATOMS,
    "algorithm.policy_hidden_sizes": (32, 16),
    "algorithm.critic_hidden_sizes": (32, 16),
    "algorithm.evaluation_active": False,
}


def _load(model, states):
    model.policy.module.load_state_dict(convert.squashed_gaussian_policy_state_dict(np_tree(states["policy"].params)))
    model.critic.module.load_state_dict(convert.vector_q_critic_state_dict(np_tree(states["critic"].params)))
    model.critic.target.load_state_dict(convert.vector_q_critic_state_dict(np_tree(states["critic"].target_params)))
    model.alpha.module.load_state_dict(convert.entropy_coefficient_state_dict(np_tree(states["alpha"].params)))
    model.obs_normalizer = to_torch(states["obs_normalizer"])


def _assert_states(model, states, tol, when):
    assert_state_dict(model.policy.module, convert.squashed_gaussian_policy_state_dict(np_tree(states["policy"].params)),
                      tol, f"{when}: policy")
    for module, field in ((model.critic.module, "params"), (model.critic.target, "target_params")):
        ref = convert.vector_q_critic_state_dict(np_tree(getattr(states["critic"], field)))
        assert_state_dict(module, ref, tol, f"{when}: critic {field}")
    assert_state_dict(model.alpha.module, convert.entropy_coefficient_state_dict(np_tree(states["alpha"].params)),
                      tol, f"{when}: log_alpha")


def _nstep_batch(rng):
    out = batch(rng, B, OBS, ACT, scale=3.0)
    out["n_step_next_observation"] = out.pop("next_observation")
    out["n_step_reward"] = 2.0 * out.pop("reward")
    out["n_step_terminated"] = out.pop("terminated")
    out["n_step_gamma"] = (0.97 ** rng.integers(1, 4, size=B)).astype(np.float32)
    out.pop("truncated")
    return out


@pytest.mark.parametrize("n_step", [1, 3])
def test_two_updates_match_jax(n_step):
    """Steps 0 and 1 from converted parameters; the normalizer holds a
    shifted, scaled running state on both sides; f32, 1e-5."""
    import jax
    import jax.numpy as jnp

    jmodel, model = models("fastsac", {**SMALL, "algorithm.n_step": n_step}, "locomotion.ant")
    rng = np.random.default_rng(n_step)
    normalizer = {"mean": jnp.asarray(rng.normal(size=OBS), jnp.float32),
                  "var": jnp.asarray(rng.uniform(0.5, 4.0, size=OBS), jnp.float32),
                  "count": jnp.asarray(100.0, jnp.float32)}
    states = {**jmodel.states, "obs_normalizer": normalizer}
    _load(model, states)
    _assert_states(model, states, 0.0, "converted")
    jupdate = jax.jit(jmodel.update)
    for step in (0, 1):
        data = _nstep_batch(rng) if n_step > 1 else batch(rng, B, OBS, ACT, scale=3.0)
        key = jax.random.PRNGKey(10 + step)
        states, jmetrics = jupdate(states, data, key, step)
        target_key, current_key = jax.random.split(key)
        metrics = model.update(to_torch(data), step, target_noise=normals(target_key, (B, ACT)),
                               current_noise=normals(current_key, (B, ACT)))
        assert set(metrics) == set(jmetrics)
        for k in jmetrics:
            close(float(metrics[k]), float(jmetrics[k]), 1e-5, f"step {step}: {k}")
        _assert_states(model, states, 1e-5, f"after step {step}")
    assert model.policy.step_count() == model.critic.step_count() == model.alpha.step_count() == 2


@pytest.mark.parametrize("v_min, v_max", [(-10.0, 10.0), (-800.0, 100.0)])
def test_entropy_shifted_projection_matches_jax(v_min, v_max):
    """FastSAC's target support (reward + gamma (1 - d) (atoms - alpha log
    pi)) through the port's plain B3 and the JAX package's projection, 101
    atoms, rows pushed past both ends by the entropy term: 1e-5."""
    import jax.numpy as jnp

    from rlx_tpu.ops.distributional import categorical_projection_dense as jax_projection
    from rlx_tpu_torch.ops.distributional import categorical_projection_dense

    rng = np.random.default_rng(7)
    atoms = np.linspace(v_min, v_max, 101, dtype=np.float32)
    n, span = 256, v_max - v_min
    reward = (0.05 * span * rng.normal(size=(n, 1))).astype(np.float32)
    done = (rng.random((n, 1)) < 0.1).astype(np.float32)
    done[:64] = 0.0
    alpha_log_pi = (rng.normal(size=(n, 1)) * 0.1 * span).astype(np.float32)
    alpha_log_pi[:32] = -2.0 * span     # every position beyond v_max
    alpha_log_pi[32:64] = 2.0 * span    # every position below v_min
    target_z = reward + 0.97 * (1.0 - done) * (atoms[None] - alpha_log_pi)
    probs = rng.dirichlet(np.ones(101), size=n).astype(np.float32)
    ours = categorical_projection_dense(torch.tensor(target_z), torch.tensor(probs), v_min, v_max, 101)
    ref = jax_projection(jnp.asarray(target_z), jnp.asarray(probs), v_min, v_max, 101)
    close(ours, ref, 1e-5, "projection")
    np.testing.assert_allclose(ours[:32, -1].numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(ours[32:64, 0].numpy(), 1.0, atol=1e-5)


def test_fastsac_trains_on_pendulum_and_carries_a_jax_checkpoint(tmp_path):
    import jax

    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config
    from rlx_tpu.utils.checkpoint import load_model_file

    overrides = {**SMALL, "algorithm.total_timesteps": 320, "algorithm.learning_starts": 128,
                 "algorithm.buffer_size": 2048, "algorithm.logging_frequency": 64}
    model = create_model(make_config("fastsac.cuda", "classic.pendulum.cuda", **overrides,
                                     **{"runner.device": "cpu"}))
    model.train()
    assert [m["steps/nr_updates"] for m in model.metrics_history] == [8, 16, 24]
    assert all(np.isfinite(v) for m in model.metrics_history for v in m.values())
    assert float(model.obs_normalizer["count"]) == pytest.approx(1e-4 + 24 * 8)

    jmodel = jax_create_model(jax_make_config("fastsac.tpu", "classic.pendulum.tpu", **SMALL, **{
        "runner.mesh_dp": 1, "runner.save_model": True}), run_path=str(tmp_path / "jax"))
    states = jmodel.states
    jmodel.states = {**states, "critic": states["critic"].replace(
        target_params=jax.tree.map(lambda x: -x, states["critic"].params))}
    jmodel.save()
    restored, _ = load_model_file(str(tmp_path / "jax" / "models" / "latest.model"))
    port = create_model(make_config("fastsac.cuda", "classic.pendulum.cuda", **SMALL, **{"runner.device": "cpu"}))
    assert set(port.checkpoint_tree()) == set(restored)
    port.restore_from_tree(convert.checkpoint_tree_from_jax("fastsac", np_tree(restored)))
    _assert_states(port, jmodel.states, 1e-6, "restored")
    obs = (3.0 * np.random.default_rng(2).normal(size=(64, 3))).astype(np.float32)
    close(port.eval_act(torch.tensor(obs)), jmodel.eval_act(jmodel.states, obs), 1e-6, "eval_act")
