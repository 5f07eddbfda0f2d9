"""The image path of the port's algorithms against the JAX package's, on the
CPU:

- the uint8 replay: each field its own ``[capacity, nr_envs, ...]`` tensor
  of its own type (image rows uint8), written in place; an exact round
  trip through ``add``, ``data`` and ``set_data``; ``sample`` and
  ``sample_nstep`` against JAX's on the indices JAX draws; the off-policy
  core storing an env's float frames as uint8 without loss;
- one update of DQN, DDQN, C51 (through the plain version of kernel B3)
  and DQN-HL-Gauss on uint8 pixel batches, one PQN learning iteration
  (JAX's recorded rollout and permutations) and one PPO ``_optimize`` on
  image observations (JAX's permutations), all from converted NatureCNN
  parameters: every metric and parameter.  f32 on both sides; Adam's
  first steps move each weight by ~lr: 1e-5;
- a train -> save -> load -> test round trip through the ``Runner`` on
  each pixel env.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlx_tpu_torch import convert
from rlx_tpu_torch.config import create_model, make_config
from rlx_tpu_torch.ops import replay_buffer as rb
from rlx_tpu_torch.runner.runner import Runner
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

TOL = 1e-5
FRAME = (84, 84, 4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(ours, ref, what):
    np.testing.assert_allclose(np.asarray(ours, np.float32), np.asarray(ref, np.float32), rtol=TOL, atol=TOL,
                               err_msg=what)


def _jax_model(algorithm, environment, overrides):
    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config

    return jax_create_model(jax_make_config(f"{algorithm}.tpu", f"{environment}.tpu", **overrides,
                                            **{"runner.mesh_dp": 1}))


def _port_model(algorithm, environment, overrides):
    return create_model(make_config(f"{algorithm}.cuda", f"{environment}.cuda", **overrides,
                                    **{"runner.device": "cpu"}))


def _specs(uint8, int32, float32):
    return {"observation": (FRAME, uint8), "next_observation": (FRAME, uint8), "action": ((), int32),
            "reward": ((), float32), "terminated": ((), float32), "truncated": ((), float32)}


def _rows(nr_rows, nr_envs, seed):
    rng = np.random.default_rng(seed)
    return [{
        "observation": rng.integers(0, 256, size=(nr_envs,) + FRAME).astype(np.uint8),
        "next_observation": rng.integers(0, 256, size=(nr_envs,) + FRAME).astype(np.uint8),
        "action": rng.integers(0, 4, size=nr_envs).astype(np.int32),
        "reward": rng.normal(size=nr_envs).astype(np.float32),
        "terminated": (rng.random(nr_envs) < 0.3).astype(np.float32),
        "truncated": (rng.random(nr_envs) < 0.2).astype(np.float32),
    } for _ in range(nr_rows)]


def _filled(capacity, nr_envs, nr_rows):
    from rlx_tpu.ops import replay_buffer as jax_rb

    ours = rb.create(capacity, nr_envs, _specs(torch.uint8, torch.int32, torch.float32))
    ref = jax_rb.create(capacity, nr_envs, _specs(jnp.uint8, jnp.int32, jnp.float32))
    for row in _rows(nr_rows, nr_envs, nr_rows):
        rb.add(ours, {k: torch.tensor(v) for k, v in row.items()})
        ref = jax_rb.add(ref, {k: jnp.asarray(v) for k, v in row.items()})
    return ours, ref


def _assert_equal(ours, ref):
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].numpy().dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_uint8_replay_layout_and_round_trip():
    ours, ref = _filled(capacity=6, nr_envs=3, nr_rows=9)    # full and wrapped
    assert not ours.packed and not ref.packed
    assert (ours.capacity, ours.nr_envs, ours.pos, ours.size) == (6, 3, int(ref.pos), int(ref.size)) == (6, 3, 3, 6)
    assert ours.storage["observation"].dtype == torch.uint8
    assert ours.storage["observation"].shape == (6, 3) + FRAME
    assert ours.nbytes == 6 * 3 * (2 * 84 * 84 * 4 + 4 * 4)
    _assert_equal(ours.data, ref.data)
    # set_data writes every field in place; data gives it back unchanged
    rows = _rows(6, 3, 100)
    data = {k: torch.tensor(np.stack([r[k] for r in rows])) for k in rows[0]}
    storage = ours.storage["observation"]
    rb.set_data(ours, data)
    assert ours.storage["observation"] is storage
    _assert_equal(ours.data, {k: v.numpy() for k, v in data.items()})
    # the packed layout round-trips through set_data too
    packed = rb.create(4, 2, {"reward": ((), torch.float32), "action": ((2,), torch.float32)})
    flat = {"reward": torch.randn(4, 2), "action": torch.randn(4, 2, 2)}
    rb.set_data(packed, flat)
    assert packed.packed and packed.nbytes == 4 * 2 * 3 * 4
    _assert_equal(packed.data, {k: v.numpy() for k, v in flat.items()})


@pytest.mark.parametrize("nr_rows", [4, 9])
def test_uint8_replay_samples_match_jax(nr_rows):
    """``sample`` and ``sample_nstep`` (n = 3, write head re-based when
    full) on the indices JAX draws from its key: every field, uint8 frames
    included, equal."""
    from rlx_tpu.ops import replay_buffer as jax_rb

    ours, ref = _filled(capacity=6, nr_envs=3, nr_rows=nr_rows)
    key = jax.random.PRNGKey(nr_rows)
    time_key, env_key = jax.random.split(key)
    t_idx = jax.random.randint(time_key, (16,), 0, ref.size)
    e_idx = jax.random.randint(env_key, (16,), 0, ref.nr_envs)
    batch = rb.sample(ours, None, 16, t_idx=torch.tensor(np.asarray(t_idx)).long(),
                      e_idx=torch.tensor(np.asarray(e_idx)).long())
    _assert_equal(batch, jax_rb.sample(ref, key, 16, shard_local=False))
    assert batch["observation"].dtype == torch.uint8
    t0 = jax.random.randint(time_key, (16,), 0, max(int(ref.size) - 3 + 1, 1))
    nstep = rb.sample_nstep(ours, None, 16, 3, 0.97, t0=torch.tensor(np.asarray(t0)).long(),
                            e_idx=torch.tensor(np.asarray(e_idx)).long())
    expected = jax_rb.sample_nstep(ref, key, 16, 3, 0.97, shard_local=False)
    assert set(nstep) == set(expected)
    for k in expected:
        np.testing.assert_allclose(nstep[k].numpy(), np.asarray(expected[k]), rtol=1e-6, atol=1e-6, err_msg=k)
    assert nstep["n_step_next_observation"].dtype == torch.uint8


def test_offpolicy_core_stores_frames_as_uint8():
    """An env step's float32 frames (integral, 0..255) go into the replay as
    uint8, observation and next observation alike, without loss."""
    model = _port_model("dqn", "classic.pixel_chase", {"environment.nr_envs": 4, "algorithm.buffer_size": 32,
                                                        "algorithm.learning_starts": 8})
    assert model.image_shape == FRAME and model.obs_store_dtype == torch.uint8
    buffer = model._make_buffer()
    env_state = model.train_env.reset(3)
    for _ in range(12):      # 12 writes wrap the 8-row buffer
        observation = env_state.observation
        action = model._random_action()
        env_state = model.train_env.step(env_state, action)
        model._store_step(buffer, observation, action, env_state)
    assert buffer.storage["observation"].dtype == buffer.storage["next_observation"].dtype == torch.uint8
    last = (buffer.pos - 1) % buffer.capacity
    assert torch.equal(buffer.storage["next_observation"][last].float(), env_state.final_observation)
    assert buffer.nbytes == model.capacity * 4 * (2 * 84 * 84 * 4 + 4 * 4)


def _pixel_batch(rng, size, frame, nr_actions=4, atom_rows=0):
    batch = {
        "observation": rng.integers(0, 256, size=(size,) + frame).astype(np.uint8),
        "next_observation": rng.integers(0, 256, size=(size,) + frame).astype(np.uint8),
        "action": rng.integers(0, nr_actions, size=size).astype(np.int32),
        "reward": (2.0 * rng.normal(size=size)).astype(np.float32),
        "terminated": (rng.random(size) < 0.25).astype(np.float32),
        "truncated": np.zeros(size, np.float32),
    }
    batch["reward"][:atom_rows] = 0.0
    batch["terminated"][:atom_rows] = 1.0
    return batch


@pytest.mark.parametrize("algorithm,environment", [("dqn", "classic.pixel_grid"), ("ddqn", "classic.pixel_chase"),
                                                   ("c51", "classic.pixel_chase"),
                                                   ("dqn_hl_gauss", "classic.pixel_grid")])
def test_dqn_family_update_on_pixels_matches_jax(algorithm, environment):
    """One update at step 0 (an Adam step and the target copy) on a uint8
    batch; C51's target goes through the plain version of kernel B3, with
    rows that put every position on one atom (reward 0, terminated).  In
    float64 on both sides (the frames' ``x / 255`` stays float32 on both):
    of the 1.6M weights of NatureCNN's Dense layer a few see a gradient
    near Adam's eps, where f32 rounding alone moves a weight by up to 2e-5
    in either package."""
    overrides = {"environment.nr_envs": 4, "algorithm.batch_size": 8, "algorithm.update_frequency": 4,
                 "algorithm.target_update_frequency": 8, "algorithm.evaluation_active": False}
    jmodel, model = _jax_model(algorithm, environment, overrides), _port_model(algorithm, environment, overrides)
    frame = model.os_shape
    critic = jmodel.states["critic"]
    model.critic.module.load_state_dict(convert.discrete_q_net_state_dict(_np_tree(critic.params)))
    model.critic.target.load_state_dict(convert.discrete_q_net_state_dict(_np_tree(critic.target_params)))
    assert model.critic.module.vision
    batch = _pixel_batch(np.random.default_rng(len(algorithm)), 8, frame, atom_rows=2)
    with jax.enable_x64(True):
        states = jax.tree.map(lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a,
                              jmodel.states)
        model.critic.module.double()
        model.critic.target.double()
        if algorithm == "c51":
            # JAX's float32 support: jnp.linspace rounds a few atoms other
            # than torch.linspace, in the last bit
            model.atoms = torch.tensor(np.asarray(jmodel.atoms))
        batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}
        states, jmetrics = jax.jit(jmodel.update)(states, batch, jax.random.PRNGKey(5), 0)
        metrics = model.update({k: torch.tensor(v) for k, v in batch.items()}, 0)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        _close(float(metrics[k]), float(jmetrics[k]), f"{algorithm}: {k}")
    for module, field in ((model.critic.module, "params"), (model.critic.target, "target_params")):
        ref = _np_tree(getattr(states["critic"], field))
        ref = convert.discrete_q_net_state_dict(jax.tree.map(lambda a: a.astype(np.float64), ref))
        for key, value in ref.items():
            torch.testing.assert_close(module.state_dict()[key].float(), value, rtol=TOL, atol=TOL,
                                       msg=lambda m: f"{algorithm} {field} {key}: {m}")
    assert model.critic.step_count() == 1


def test_pqn_learning_iteration_on_pixels_matches_jax(monkeypatch):
    """JAX's learning iteration on ``pixel_grid`` with its scans recorded;
    the port gets its rollout (float32 frames) and its permutations, from
    converted parameters, and must give its Q(lambda) targets, metrics and
    parameters."""
    nr_envs, nr_steps = 4, 4
    overrides = {"environment.nr_envs": nr_envs, "algorithm.nr_steps": nr_steps, "algorithm.nr_epochs": 2,
                 "algorithm.nr_minibatches": 2, "algorithm.total_timesteps": 4 * nr_envs * nr_steps,
                 "algorithm.evaluation_active": False}
    jmodel, model = _jax_model("pqn", "classic.pixel_grid", overrides), _port_model("pqn", "classic.pixel_grid",
                                                                                  overrides)
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
    (critic_state, _, _), _ = jax.block_until_ready(jax.jit(jmodel._learning_iteration)(
        (jmodel.critic_state, env_state, jax.random.PRNGKey(2)), 1, 0))
    monkeypatch.undo()
    scans = dict(scans)
    (_, _, key), (observations, final_observations, actions, rewards, terminations, _) = scans["single_rollout_step"]
    assert np.asarray(observations).shape == (nr_steps, nr_envs, 84, 84, 1)
    _, perm_key = jax.random.split(key)
    batch_size = nr_envs * nr_steps
    epoch_indices = jax.random.permutation(perm_key, np.tile(np.arange(batch_size), (2, 1)), axis=1,
                                           independent=True)
    batch = tuple(torch.tensor(np.asarray(v)) for v in (observations, final_observations, actions, rewards,
                                                         terminations))
    with torch.no_grad():
        next_values = model.q_net(batch[1]).max(dim=-1).values
    _close(model.q_lambda_targets(batch[3], batch[4], next_values), scans["compute_q_targets"][1], "targets")
    metrics = model._learn(batch, torch.tensor(np.asarray(epoch_indices)))
    for name, ref in to_torch(critic_state.params).items():
        torch.testing.assert_close(model.q_net.state_dict()[name], ref, rtol=TOL, atol=TOL,
                                   msg=lambda m: f"{name}: {m}")
    (jmetrics,) = logged
    for k in ("loss/q_loss", "q_value/q_value", "gradients/critic_grad_norm"):
        _close(float(metrics[k]), float(jmetrics[k]), k)


def test_ppo_optimize_on_pixels_matches_jax():
    """One ``_optimize`` on image observations ``[16, 84, 84, 4]`` (per-
    minibatch gathers), discrete actions, NatureCNN policy and critic, with
    JAX's permutations: every parameter and metric."""
    nr_envs, nr_steps, minibatch, epochs = 4, 4, 8, 2
    overrides = {"environment.nr_envs": nr_envs, "algorithm.nr_steps": nr_steps,
                 "algorithm.minibatch_size": minibatch, "algorithm.nr_epochs": epochs,
                 "algorithm.total_timesteps": 2 * nr_envs * nr_steps, "algorithm.entropy_coef": 0.01,
                 "algorithm.evaluation_active": False, "algorithm.logging_active": False}
    jmodel, model = _jax_model("ppo", "classic.pixel_chase", overrides), _port_model("ppo", "classic.pixel_chase",
                                                                                   overrides)
    model.policy.module.load_state_dict(convert.categorical_policy_state_dict(_np_tree(jmodel.policy_state.params)))
    model.critic.load_state_dict(convert.critic_state_dict(_np_tree(jmodel.critic_state.params)))
    N = nr_envs * nr_steps
    rng = np.random.default_rng(0)
    batch = (rng.integers(0, 256, size=(N,) + FRAME).astype(np.float32), rng.integers(0, 4, size=N).astype(np.int32),
             rng.normal(size=N).astype(np.float32) - 1.4, rng.normal(size=N).astype(np.float32),
             rng.normal(size=N).astype(np.float32))
    key = jax.random.PRNGKey(7)
    _, perm_key = jax.random.split(key)
    epoch_indices = jax.random.permutation(perm_key, np.tile(np.arange(N), (epochs, 1)), axis=1, independent=True)
    policy_state, critic_state, jmetrics = jmodel._optimize(jmodel.policy_state, jmodel.critic_state,
                                                            tuple(jnp.asarray(x) for x in batch), key)
    metrics = model._optimize(tuple(torch.tensor(x) for x in batch), torch.tensor(np.asarray(epoch_indices)))
    for name, ref in convert.categorical_policy_state_dict(_np_tree(policy_state.params)).items():
        torch.testing.assert_close(model.policy.module.state_dict()[name], ref, rtol=TOL, atol=TOL,
                                   msg=lambda m: f"policy {name}: {m}")
    for name, ref in convert.critic_state_dict(_np_tree(critic_state.params)).items():
        torch.testing.assert_close(model.critic.state_dict()[name], ref, rtol=TOL, atol=TOL,
                                   msg=lambda m: f"critic {name}: {m}")
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-4, atol=TOL, err_msg=k)
    assert model.nr_optimizer_steps == epochs * N // minibatch


@pytest.mark.parametrize("algorithm,environment,budget", [
    ("dqn", "classic.pixel_chase.cuda", ["--algorithm.total_timesteps=96", "--algorithm.learning_starts=32",
                                         "--algorithm.batch_size=8", "--algorithm.buffer_size=64",
                                         "--algorithm.logging_frequency=32",
                                         "--algorithm.evaluation_and_save_frequency=32"]),
    ("pqn", "classic.pixel_grid.cuda", ["--algorithm.total_timesteps=64", "--algorithm.nr_steps=8",
                                        "--algorithm.evaluation_and_save_frequency=32"]),
    ("ppo", "classic.pixel_chase.cuda", ["--algorithm.total_timesteps=64", "--algorithm.nr_steps=8",
                                         "--algorithm.minibatch_size=16", "--algorithm.nr_epochs=1",
                                         "--algorithm.evaluation_and_save_frequency=32"]),
])
def test_runner_round_trip_on_pixels(tmp_path, monkeypatch, algorithm, environment, budget):
    """Train with evaluation and saves, then test mode from ``latest.model``:
    every saved tensor loaded as it was, finite test returns (float32
    frames from the env into the NatureCNN nets)."""
    monkeypatch.chdir(tmp_path)
    args = [f"--algorithm.name={algorithm}.cuda", f"--environment.name={environment}", "--runner.device=cpu",
            "--environment.nr_envs=4", "--environment.horizon=16"]
    trained = Runner([*args, *budget, "--runner.save_model=True", "--runner.run_name=pixels"]).run()
    assert len(trained.eval_history["eval/episode_return"]) == 2
    latest = tmp_path / "runs" / "rlx_tpu_torch" / "default" / "pixels" / "models" / "latest.model"
    tester = Runner([*args, "--runner.mode=test", f"--runner.load_model={latest}", "--runner.nr_test_episodes=4",
                     "--runner.run_name=pixels_test"])
    returns = tester.run()
    assert len(returns) == 4 and all(np.isfinite(returns))
    saved, loaded = trained.checkpoint_tree(), tester.model.checkpoint_tree()
    assert set(saved) == set(loaded)
    for name in saved:
        assert any(k.startswith("trunk.convs.") for k in saved[name])
        for k, v in saved[name].items():
            assert torch.equal(v, loaded[name][k]), (name, k)
