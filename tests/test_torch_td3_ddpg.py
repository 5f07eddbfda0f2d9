"""The port's TD3 and DDPG against the JAX package's:

- two consecutive ``update`` calls from converted parameters on the same
  batch against JAX ``update``: TD3's step 0 steps the policy and moves
  both targets, its step 1 (``policy_delay`` 2) steps the critic only, with
  JAX's smoothing noise replayed; DDPG steps everything on both.  Every
  metric, every parameter and target after each call;
- ``act`` with JAX's exploration noise replayed, and ``eval_act``;
- ``train()`` on the Ant and on Pendulum with the JAX package's sizing, and
  a JAX ``latest.model`` carried into the port (DDPG's flax critic is a
  plain ``QCritic``, TD3's a vmapped pair).
"""

import numpy as np
import pytest
import torch

from rlx_tpu_torch import convert
from rlx_tpu_torch.config import create_model, make_config
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
CRITIC = {"td3": convert.vector_q_critic_state_dict, "ddpg": convert.q_critic_state_dict}


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _close(ours, ref, tol, what):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=tol, atol=tol, err_msg=what)


def _jax_model(algorithm, environment, overrides, **kw):
    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config

    config = jax_make_config(f"{algorithm}.tpu", environment, **overrides, **{"runner.mesh_dp": 1})
    return jax_create_model(config, **kw)


def _models(algorithm):
    jmodel = _jax_model(algorithm, "locomotion.ant.tpu", SMALL)
    model = create_model(make_config(f"{algorithm}.cuda", "locomotion.ant.cuda", **SMALL,
                                     **{"runner.device": "cpu"}))
    for name, to_torch in (("policy", convert.deterministic_policy_state_dict), ("critic", CRITIC[algorithm])):
        state = getattr(model, name)
        state.module.load_state_dict(to_torch(_np_tree(jmodel.states[name].params)))
        state.target.load_state_dict(to_torch(_np_tree(jmodel.states[name].target_params)))
    return jmodel, model


def _assert_states_match(algorithm, model, states, tol, when):
    for name, to_torch in (("policy", convert.deterministic_policy_state_dict), ("critic", CRITIC[algorithm])):
        state = getattr(model, name)
        for module, field in ((state.module, "params"), (state.target, "target_params")):
            ref = to_torch(_np_tree(getattr(states[name], field)))
            got = module.state_dict()
            assert set(got) == set(ref), (name, field)
            for key in ref:
                torch.testing.assert_close(got[key], ref[key], rtol=tol, atol=tol,
                                           msg=lambda m: f"{when}: {name} {field} {key}: {m}")


def _batch(rng):
    batch = {
        "observation": rng.normal(size=(B, OBS)),
        "action": rng.uniform(-1, 1, size=(B, ACT)),
        "next_observation": rng.normal(size=(B, OBS)),
        "reward": rng.normal(size=B),
        "terminated": (rng.random(B) < 0.25).astype(np.float64),
        "truncated": np.zeros(B),
    }
    return {k: v.astype(np.float32) for k, v in batch.items()}


@pytest.mark.parametrize("algorithm", ["td3", "ddpg"])
def test_two_updates_match_jax(algorithm):
    """Steps 0 and 1 on converted parameters and the same batches (TD3 with
    JAX's smoothing noise, which it draws from the update key itself).  f32
    on both sides, Adam's first steps move each weight by ~lr: 1e-5."""
    import jax

    jmodel, model = _models(algorithm)
    states = jmodel.states
    _assert_states_match(algorithm, model, states, 0.0, "converted")
    rng = np.random.default_rng(7)
    jupdate = jax.jit(jmodel.update)
    for step in (0, 1):
        batch = _batch(rng)
        key = jax.random.PRNGKey(30 + step)
        states, jmetrics = jupdate(states, batch, key, step)
        noise = {}
        if algorithm == "td3":
            noise["smoothing_noise"] = torch.tensor(np.asarray(jax.random.normal(key, (B, ACT))))
        metrics = model.update({k: torch.tensor(v) for k, v in batch.items()}, step, **noise)
        assert set(metrics) == set(jmetrics)
        for k in jmetrics:
            _close(float(metrics[k]), float(jmetrics[k]), 1e-5, f"step {step}: {k}")
        _assert_states_match(algorithm, model, states, 1e-5, f"after step {step}")
    # TD3's delayed policy took one Adam step (its flax step counter two),
    # DDPG's two; the critics two each
    policy_steps = 1 if algorithm == "td3" else 2
    assert model.policy.step_count() == int(states["policy"].opt_state.count) == policy_steps
    assert model.critic.step_count() == int(states["critic"].opt_state.count) == 2


@pytest.mark.parametrize("algorithm", ["td3", "ddpg"])
def test_act_and_eval_act_match_jax(algorithm):
    import jax

    jmodel, model = _models(algorithm)
    obs = (3.0 * np.random.default_rng(5).normal(size=(8, OBS))).astype(np.float32)
    key = jax.random.PRNGKey(4)
    noise = torch.tensor(np.asarray(jax.random.normal(key, (8, ACT))))
    _close(model.act(torch.tensor(obs), noise=noise), jmodel.act(jmodel.states, obs, key, 0), 1e-5, "act")
    _close(model.eval_act(torch.tensor(obs)), jmodel.eval_act(jmodel.states, obs), 1e-5, "eval_act")


@pytest.mark.parametrize("environment", ["locomotion.ant.cuda", "classic.pendulum.cuda"])
@pytest.mark.parametrize("algorithm", ["td3", "ddpg"])
def test_trains_with_the_jax_sizing(algorithm, environment):
    overrides = {**SMALL, **TRAIN, "algorithm.evaluation_active": environment != "locomotion.ant.cuda"}
    model = create_model(make_config(f"{algorithm}.cuda", environment, **overrides, **{"runner.device": "cpu"}))
    jmodel = _jax_model(algorithm, "classic.pendulum.tpu", overrides)
    assert [getattr(model, k) for k in SIZING] == [getattr(jmodel, k) for k in SIZING]
    initial = [p.detach().clone() for p in model.policy.module.parameters()]
    model.train()
    assert any(not torch.equal(a, b) for a, b in zip(initial, model.policy.module.parameters()))
    for state in (model.policy, model.critic):
        for module in (state.module, state.target):
            assert all(torch.isfinite(p).all() for p in module.parameters())
    # 16 prefill steps, then 24 learning steps in 3 log lines of 8
    assert model.prefill_iterations == 16
    assert [m["steps/nr_updates"] for m in model.metrics_history] == [8, 16, 24]
    assert all(np.isfinite(v) for m in model.metrics_history for v in m.values())
    if model.eval_history is not None:
        assert list(model.eval_history["steps"]) == [320]
        assert np.isfinite(model.eval_history["eval/episode_return"]).all()


@pytest.mark.parametrize("algorithm", ["td3", "ddpg"])
def test_jax_checkpoint_carries_into_the_port(algorithm, tmp_path):
    """The key set of a JAX ``latest.model`` is the port's, and its
    parameters and targets give the port JAX's ``eval_act`` and critics."""
    import jax

    from rlx_tpu.utils.checkpoint import load_model_file

    jmodel = _jax_model(algorithm, "classic.pendulum.tpu", {**SMALL, "runner.save_model": True},
                        run_path=str(tmp_path / "jax"))
    states = jmodel.states
    jmodel.states = {
        "policy": states["policy"].replace(target_params=jax.tree.map(lambda x: 0.5 * x, states["policy"].params)),
        "critic": states["critic"].replace(target_params=jax.tree.map(lambda x: -x, states["critic"].params)),
    }
    jmodel.save()
    restored, _ = load_model_file(str(tmp_path / "jax" / "models" / "latest.model"))
    port = create_model(make_config(f"{algorithm}.cuda", "classic.pendulum.cuda", **SMALL,
                                    **{"runner.device": "cpu"}))
    assert set(port.checkpoint_tree()) == set(restored) == {"policy", "policy_target", "critic", "critic_target"}
    port.restore_from_tree(convert.checkpoint_tree_from_jax(algorithm, _np_tree(restored)))
    _assert_states_match(algorithm, port, jmodel.states, 1e-6, "restored")
    rng = np.random.default_rng(2)
    obs = (3.0 * rng.normal(size=(64, 3))).astype(np.float32)
    action = rng.uniform(-1, 1, size=(64, 1)).astype(np.float32)
    _close(port.eval_act(torch.tensor(obs)), jmodel.eval_act(jmodel.states, obs), 1e-6, "eval_act")
    with torch.no_grad():
        ours = port.critic.target(torch.tensor(obs), torch.tensor(action))
    _close(ours, jmodel.critic.apply(jmodel.states["critic"].target_params, obs, action), 1e-6, "critic target")


@pytest.mark.parametrize("algorithm", ["td3", "ddpg"])
def test_left_out_features_raise_and_anneal_is_accepted(algorithm):
    with pytest.raises(KeyError):
        make_config(f"{algorithm}.cuda", "classic.pendulum.cuda", **{"algorithm.shard_local_sampling": False})
    # parallel seeds are ported: the key is there
    assert make_config(f"{algorithm}.cuda", "classic.pendulum.cuda", **{"algorithm.nr_parallel_seeds": 2}
                       ).algorithm.nr_parallel_seeds == 2
    config = make_config(f"{algorithm}.cuda", "classic.pendulum.cuda", **{"algorithm.anneal_learning_rate": "true"})
    assert config.algorithm.anneal_learning_rate is True
