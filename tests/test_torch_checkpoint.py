"""The port's checkpoints, config merge and test-mode collection against the
JAX package's:

- ``collect_test_returns`` of both packages on one scripted sequence of done
  masks and returns;
- ``merge_loaded_algorithm_config`` of both packages on the same dicts;
- a JAX ``latest.model`` (read by the JAX package) carried into a port
  ``latest.model`` by ``convert.checkpoint_tree_from_jax``, for PPO and
  FastTD3;
- the port's own save -> load round trips, bit for bit, and one more update
  after a full-state restore equal to the model that never saved.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rlx_tpu_torch import convert
from rlx_tpu_torch.algorithms.evaluation import collect_test_returns
from rlx_tpu_torch.config import create_env, create_model, make_config
from rlx_tpu_torch.utils import checkpoint as ckpt
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

HIDDEN = (16, 16)


def assert_same_tree(a, b, where="tree"):
    """Every tensor equal bit for bit, every other leaf equal."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            assert_same_tree(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{where}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()), where
    else:
        assert a == b, where


# --- test mode ---------------------------------------------------------------

def _scripted_steps(done_rows, return_rows, to_array):
    """A fake ``step_fn``: step t gives row t of the script (cycled)."""
    def step(t):
        t = t + 1
        row = (t - 1) % len(done_rows)
        done = np.asarray(done_rows[row], bool)
        state = SimpleNamespace(
            terminated=to_array(done & (np.arange(done.size) % 2 == 0)),
            truncated=to_array(done & (np.arange(done.size) % 2 == 1)),
            info={"rollout/episode_return": to_array(np.asarray(return_rows[row], np.float32))},
        )
        state.t = t
        return state

    return lambda state: step(state.t)


@pytest.mark.parametrize("case", ["several done at once", "cap reached", "fewer episodes than asked"])
def test_collect_test_returns_matches_jax(case):
    from rlx_tpu.algorithms import evaluation as jax_evaluation

    rng = np.random.default_rng(3)
    if case == "several done at once":
        done = [[0, 0, 0, 0], [1, 0, 1, 1], [0, 0, 0, 0], [0, 1, 0, 1], [1, 1, 1, 1]]
        episodes, horizon = 7, 5
    elif case == "cap reached":   # one done in 7 steps, cap max(2 * 3 * 2, 2) = 12 steps
        done = [[0, 0, 0]] * 6 + [[0, 1, 0]]
        episodes, horizon = 3, 2
    else:   # 4 done in the first step, 2 asked
        done = [[1, 1, 1, 1], [0, 0, 0, 0]]
        episodes, horizon = 2, 4
    returns = (100.0 * rng.normal(size=(len(done), len(done[0])))).astype(np.float32)

    ours = collect_test_returns(_scripted_steps(done, returns, torch.as_tensor),
                                SimpleNamespace(t=0), episodes, horizon)
    ref = jax_evaluation.collect_test_returns(_scripted_steps(done, returns, np.asarray),
                                              SimpleNamespace(t=0), episodes, horizon)
    assert ours == ref
    expected_len = {"several done at once": 7, "cap reached": 1, "fewer episodes than asked": 2}[case]
    assert len(ours) == expected_len


# --- config merge --------------------------------------------------------------

@pytest.mark.parametrize("explicit", [[], ["algorithm.learning_rate"],
                                      ["algorithm.nr_steps", "algorithm.policy_hidden_sizes"]])
def test_merge_loaded_algorithm_config_matches_jax(explicit):
    from rlx_tpu.config import make_config as jax_make_config
    from rlx_tpu.utils import checkpoint as jax_ckpt

    explicit_values = {"algorithm.learning_rate": 0.5, "algorithm.nr_steps": 7,
                       "algorithm.policy_hidden_sizes": (8, 8)}
    overrides = {k: explicit_values[k] for k in explicit}
    config = make_config("ppo.cuda", "classic.pendulum.cuda", **overrides)
    jax_config = jax_make_config("ppo.tpu", "classic.pendulum.tpu", **overrides)
    # as json.load gives them: lists for tuples, an int for a float, a key
    # the port does not have
    loaded = {"learning_rate": 0.001, "nr_steps": 256, "policy_hidden_sizes": [32, 32], "gamma": 1,
              "clip_range": 0.1, "nr_parallel_seeds": 3, "unknown_key": 5}
    ckpt.merge_loaded_algorithm_config(config, dict(loaded), explicit)
    jax_ckpt.merge_loaded_algorithm_config(jax_config, dict(loaded), explicit)
    jax_algorithm = jax_config.algorithm.to_dict()
    for key, value in config.algorithm.items():
        if key == "name":
            continue
        assert value == jax_algorithm[key] and type(value) is type(jax_algorithm[key]), key
    assert "unknown_key" not in config.algorithm and config.algorithm.nr_parallel_seeds == 3


# --- model files ---------------------------------------------------------------

def test_model_file_round_trip_leaves_no_tmp(tmp_path):
    tree = {"a": {"w": torch.randn(3, 4), "n": torch.tensor(2.5)}, "count": 7,
            "opt": {"state": {0: {"step": torch.tensor(3.0)}}, "param_groups": [{"lr": 1e-3, "betas": (0.9, 0.999)}]}}
    save_path = str(tmp_path / "models")
    ckpt.save_model_file(save_path, "latest.model", tree, {"nr_steps": 4, "hidden": [2, 2]})
    ckpt.save_model_file(save_path, "latest.model", tree, {"nr_steps": 4, "hidden": [2, 2]})
    assert sorted(os.listdir(save_path)) == ["latest.model"]
    restored, config = ckpt.load_model_file(os.path.join(save_path, "latest.model"))
    assert config == {"nr_steps": 4, "hidden": [2, 2]}
    assert_same_tree(restored, tree)


def test_save_model_needs_a_run_path():
    config = make_config("ppo.cuda", "classic.pendulum.cuda", **{"runner.device": "cpu",
                                                                  "runner.save_model": True})
    with pytest.raises(ValueError, match="run path"):
        create_model(config)


# --- interop with JAX checkpoints ----------------------------------------------

def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _port_load(algorithm, environment, overrides, model_path, tmp_path):
    from rlx_tpu_torch.algorithms.algorithm_manager import get_algorithm_model_class

    config = make_config(algorithm, environment, **{**overrides, "runner.device": "cpu",
                                                    "runner.load_model": model_path})
    train_env, eval_env = create_env(config)
    model_class = get_algorithm_model_class(algorithm)()
    return model_class.load(config, train_env, eval_env, str(tmp_path / "loaded"), None, [])


def test_jax_ppo_checkpoint_carries_into_the_port(tmp_path):
    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config
    from rlx_tpu.utils.checkpoint import load_model_file

    shared = {"environment.nr_envs": 4, "algorithm.nr_steps": 8, "algorithm.minibatch_size": 16,
              "algorithm.nr_epochs": 2, "algorithm.total_timesteps": 64,
              "algorithm.policy_hidden_sizes": HIDDEN, "algorithm.critic_hidden_sizes": HIDDEN,
              "algorithm.evaluation_active": False, "algorithm.logging_active": False}
    jmodel = jax_create_model(jax_make_config("ppo.tpu", "classic.pendulum.tpu", **shared, **{
        "runner.mesh_dp": 1, "runner.save_model": True}), run_path=str(tmp_path / "jax"))
    jmodel.train()
    restored, _ = load_model_file(str(tmp_path / "jax" / "models" / "latest.model"))
    tree = convert.checkpoint_tree_from_jax("ppo", _np_tree(restored))

    port = create_model(make_config("ppo.cuda", "classic.pendulum.cuda", **shared, **{
        "runner.device": "cpu"}), run_path=str(tmp_path / "port"))
    port.restore_from_tree(tree)
    port.save()
    model = _port_load("ppo.cuda", "classic.pendulum.cuda", shared,
                       str(tmp_path / "port" / "models" / "latest.model"), tmp_path)

    obs = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    expected = np.asarray(jmodel.policy.mode(jmodel.policy_state.params, obs))
    with torch.no_grad():
        actions = model.policy.mode(torch.tensor(obs)).numpy()
        values = model.critic(torch.tensor(obs)).numpy()
    np.testing.assert_allclose(actions, expected, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(values, np.asarray(jmodel.critic.apply(jmodel.critic_state.params, obs)),
                               rtol=1e-5, atol=1e-5)


def test_jax_fasttd3_checkpoint_carries_into_the_port(tmp_path):
    import jax

    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config
    from rlx_tpu.ops import normalizers as jax_normalizers
    from rlx_tpu.utils.checkpoint import load_model_file

    shared = {"environment.nr_envs": 4, "algorithm.batch_size": 16, "algorithm.nr_atoms": 11,
              "algorithm.policy_hidden_sizes": HIDDEN, "algorithm.critic_hidden_sizes": HIDDEN,
              "algorithm.v_min": -50.0, "algorithm.v_max": 10.0}
    jmodel = jax_create_model(jax_make_config("fasttd3.tpu", "classic.pendulum.tpu", **shared, **{
        "runner.mesh_dp": 1, "runner.save_model": True}), run_path=str(tmp_path / "jax"))
    rng = np.random.default_rng(1)
    states = jmodel.states
    # targets apart from the parameters, a normalizer that has seen data
    states = {
        **states,
        "policy": states["policy"].replace(target_params=jax.tree.map(lambda x: 0.5 * x, states["policy"].params)),
        "critic": states["critic"].replace(target_params=jax.tree.map(lambda x: -x, states["critic"].params)),
        "obs_normalizer": jax_normalizers.obs_normalizer_update(
            states["obs_normalizer"], (2.0 * rng.normal(size=(64, 3)) + 0.5).astype(np.float32)),
    }
    jmodel.states = states
    jmodel.save()
    restored, _ = load_model_file(str(tmp_path / "jax" / "models" / "latest.model"))
    tree = convert.checkpoint_tree_from_jax("fasttd3", _np_tree(restored))

    port = create_model(make_config("fasttd3.cuda", "classic.pendulum.cuda", **shared, **{
        "runner.device": "cpu"}), run_path=str(tmp_path / "port"))
    port.restore_from_tree(tree)
    port.save()
    model = _port_load("fasttd3.cuda", "classic.pendulum.cuda", shared,
                       str(tmp_path / "port" / "models" / "latest.model"), tmp_path)

    # the carried tensors: exact transposes and copies of JAX's
    for name, to_torch in (("policy", convert.deterministic_policy_state_dict),
                           ("critic", convert.vector_q_critic_state_dict)):
        state = getattr(model, name)
        for module, params in ((state.module, states[name].params), (state.target, states[name].target_params)):
            for key, ref in to_torch(_np_tree(params)).items():
                torch.testing.assert_close(module.state_dict()[key], ref, rtol=0, atol=1e-6)
    for key, ref in states["obs_normalizer"].items():
        np.testing.assert_allclose(model.obs_normalizer[key].numpy(), np.asarray(ref), rtol=0, atol=1e-6)

    obs = (3.0 * rng.normal(size=(64, 3))).astype(np.float32)
    action = rng.uniform(-1, 1, size=(64, 1)).astype(np.float32)
    normalized = np.asarray(jax_normalizers.obs_normalize(states["obs_normalizer"], obs))
    with torch.no_grad():
        np.testing.assert_allclose(model.eval_act(torch.tensor(obs)).numpy(),
                                   np.asarray(jmodel.eval_act(states, obs)), rtol=1e-6, atol=1e-6)
        for target in (False, True):
            ours = (model.critic.target if target else model.critic.module)(
                torch.tensor(normalized), torch.tensor(action)).numpy()
            params = states["critic"].target_params if target else states["critic"].params
            ref = np.asarray(jmodel.critic.apply(params, normalized, action))
            np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6, err_msg=f"critic target={target}")


def test_jax_checkpoint_with_optimizer_state_is_refused():
    with pytest.raises(ValueError, match="optimizer state"):
        convert.checkpoint_tree_from_jax("ppo", {"full": {}})


# --- the port's round trips ----------------------------------------------------

PPO_SMALL = {"runner.device": "cpu", "environment.nr_envs": 4, "algorithm.nr_steps": 8,
             "algorithm.minibatch_size": 16, "algorithm.nr_epochs": 2, "algorithm.total_timesteps": 64,
             "algorithm.policy_hidden_sizes": HIDDEN, "algorithm.critic_hidden_sizes": HIDDEN,
             "algorithm.evaluation_active": False, "algorithm.logging_active": False}

TD3_SMALL = {"runner.device": "cpu", "environment.nr_envs": 4, "algorithm.batch_size": 16,
             "algorithm.nr_atoms": 11, "algorithm.policy_hidden_sizes": HIDDEN,
             "algorithm.critic_hidden_sizes": HIDDEN, "algorithm.learning_starts": 32,
             "algorithm.total_timesteps": 64, "algorithm.buffer_size": 256, "algorithm.n_step": 3,
             "algorithm.logging_frequency": 16, "algorithm.evaluation_active": False,
             "algorithm.logging_active": False}


def _trained(algorithm, overrides, tmp_path, full):
    config = make_config(algorithm, "classic.pendulum.cuda", **{
        **overrides, "runner.save_model": True, "runner.save_optimizer_state": full})
    model = create_model(config, run_path=str(tmp_path / "run"))
    model.train()
    model_path = str(tmp_path / "run" / "models" / "latest.model")
    assert not os.path.exists(tmp_path / "run" / "models" / "tmp")
    loaded = _port_load(algorithm, "classic.pendulum.cuda",
                        {**overrides, "runner.save_optimizer_state": full}, model_path, tmp_path)
    return model, loaded


@pytest.mark.parametrize("full", [False, True])
def test_ppo_save_load_round_trip(tmp_path, full):
    model, loaded = _trained("ppo.cuda", PPO_SMALL, tmp_path, full)
    tree = model.checkpoint_tree()
    assert set(tree) == ({"full"} if full else {"policy", "critic"})
    assert_same_tree(tree, loaded.checkpoint_tree())
    if not full:
        return
    assert loaded.nr_optimizer_steps == model.nr_optimizer_steps == 2 * 2 * 2
    # one more update on injected permutations: the loaded model equals the
    # one that never saved, bit for bit
    N = model.batch_size
    rng = np.random.default_rng(0)
    batch = tuple(torch.tensor(x) for x in (
        rng.normal(size=(N, 3)).astype(np.float32), rng.normal(size=(N, 1)).astype(np.float32),
        rng.normal(size=N).astype(np.float32) - 2.0, rng.normal(size=N).astype(np.float32),
        rng.normal(size=N).astype(np.float32)))
    epoch_indices = torch.stack([torch.tensor(rng.permutation(N)) for _ in range(model.nr_epochs)])
    for m in (model, loaded):
        m._optimize(batch, epoch_indices=epoch_indices)
    assert_same_tree(model.checkpoint_tree(), loaded.checkpoint_tree())


@pytest.mark.parametrize("full", [False, True])
def test_fasttd3_save_load_round_trip(tmp_path, full):
    model, loaded = _trained("fasttd3.cuda", TD3_SMALL, tmp_path, full)
    tree = model.checkpoint_tree()
    assert set(tree) == ({"full"} if full else
                         {"policy", "policy_target", "critic", "critic_target", "obs_normalizer"})
    assert_same_tree(tree, loaded.checkpoint_tree())
    if not full:
        return
    assert loaded.nr_updates == model.nr_updates == 8
    # one more update on an injected batch, equal bit for bit
    rng = np.random.default_rng(1)
    B = 16
    batch = {
        "observation": rng.normal(size=(B, 3)), "action": rng.uniform(-1, 1, size=(B, 1)),
        "n_step_next_observation": rng.normal(size=(B, 3)), "n_step_reward": rng.normal(size=B),
        "n_step_terminated": (rng.random(B) < 0.25).astype(np.float64),
        "n_step_gamma": 0.97 ** rng.integers(1, 4, size=B),
    }
    batch = {k: torch.tensor(v.astype(np.float32)) for k, v in batch.items()}
    noise = torch.tensor(rng.normal(size=(B, 1)).astype(np.float32))
    for m in (model, loaded):
        m.update(batch, 0, smoothing_noise=noise)
    assert_same_tree(model.checkpoint_tree(), loaded.checkpoint_tree())
