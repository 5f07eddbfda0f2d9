"""The port's discrete-action family against the JAX package's, on the CPU:

- the categorical helpers and the HL-Gauss ops on the same numpy inputs;
- ``DiscreteQNet`` (one output, atoms, ``layer_norm_all``) and
  ``CategoricalPolicy`` on converted flax parameters;
- three ``update`` calls of DQN, DDQN, C51 and DQN-HL-Gauss from converted
  parameters on the same batches: step 0 takes an Adam step and copies the
  target, step 1 neither (``update_every`` and ``target_update_every`` 2
  and 3), step 2 an Adam step only.  Every metric, parameter and target,
  and Adam's step count, after each call;
- C51's target distribution, through ``categorical_projection_dense`` on
  the CPU, against JAX's with rows whose every target lands on an atom
  (reward 0 and terminated) or clips to the support's ends;
- epsilon-greedy ``act`` with JAX's draws replayed, and ``eval_act``;
- ``train()`` with the JAX package's sizing, JAX checkpoints carried into
  the port, and the learning-check recipes equal to JAX's.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlx_tpu_torch import convert
from rlx_tpu_torch.config import create_model, make_config
from rlx_tpu_torch.models import distributions as D
from rlx_tpu_torch.models.mlp import CategoricalPolicy, DiscreteQNet
from rlx_tpu_torch.ops.distributional import hl_gauss_expectation, hl_gauss_targets
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

OBS, ACTIONS, HIDDEN, B = 4, 2, (32, 16), 16
FAMILY = ("dqn", "ddqn", "c51", "dqn_hl_gauss")
SMALL = {
    "environment.nr_envs": 8,
    "algorithm.batch_size": B,
    "algorithm.critic_hidden_sizes": HIDDEN,
    "algorithm.evaluation_active": False,
    # update_every 2, target_update_every 3 (env steps / nr_envs)
    "algorithm.update_frequency": 16,
    "algorithm.target_update_frequency": 24,
    "algorithm.epsilon_decay_steps": 80,
}
TRAIN = {
    "algorithm.total_timesteps": 320,
    "algorithm.learning_starts": 128,
    "algorithm.buffer_size": 2048,
    "algorithm.logging_frequency": 64,
}
SIZING = ("prefill_iterations", "nr_eval_save_iterations", "nr_loggings_per_eval_save_iteration",
          "nr_updates_per_logging_iteration", "capacity", "epsilon_decay_iterations", "update_every",
          "target_update_every")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(ours, ref, tol, what):
    np.testing.assert_allclose(np.asarray(ours, np.float32), np.asarray(ref, np.float32), rtol=tol, atol=tol,
                               err_msg=what)


def _jax_model(algorithm, overrides, **kw):
    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config

    config = jax_make_config(f"{algorithm}.tpu", "classic.cart_pole.tpu", **overrides, **{"runner.mesh_dp": 1})
    return jax_create_model(config, **kw)


def _models(algorithm, overrides=SMALL):
    jmodel = _jax_model(algorithm, overrides)
    model = create_model(make_config(f"{algorithm}.cuda", "classic.cart_pole.cuda", **overrides,
                                     **{"runner.device": "cpu"}))
    critic = jmodel.states["critic"]
    model.critic.module.load_state_dict(convert.discrete_q_net_state_dict(_np_tree(critic.params)))
    model.critic.target.load_state_dict(convert.discrete_q_net_state_dict(_np_tree(critic.target_params)))
    return jmodel, model


def _assert_critic_matches(model, critic, tol, when):
    for module, field in ((model.critic.module, "params"), (model.critic.target, "target_params")):
        ref = convert.discrete_q_net_state_dict(_np_tree(getattr(critic, field)))
        got = module.state_dict()
        assert set(got) == set(ref), field
        for key in ref:
            torch.testing.assert_close(got[key], ref[key], rtol=tol, atol=tol,
                                       msg=lambda m: f"{when}: {field} {key}: {m}")


def _batch(rng, atom_rows=0):
    """A replay batch; its first ``atom_rows`` rows have reward 0 and are
    terminated, so every C51 target position is the atom at 0."""
    batch = {
        "observation": rng.normal(size=(B, OBS)),
        "action": rng.integers(0, ACTIONS, size=B),
        "next_observation": rng.normal(size=(B, OBS)),
        "reward": 4.0 * rng.normal(size=B),
        "terminated": (rng.random(B) < 0.25).astype(np.float64),
        "truncated": np.zeros(B),
    }
    batch["reward"][:atom_rows] = 0.0
    batch["terminated"][:atom_rows] = 1.0
    batch["reward"][atom_rows:atom_rows + 2] = [40.0, -40.0]   # every position past v_max / v_min
    batch["terminated"][atom_rows:atom_rows + 2] = 0.0
    return {k: v.astype(np.int32 if k == "action" else np.float32) for k, v in batch.items()}


def test_categorical_helpers_match_jax():
    """Gumbel-max sampling with JAX's noise, log-probs and entropy: f32
    softmaxes on both sides, 1e-6."""
    from rlx_tpu.models import distributions as jax_d

    rng = np.random.default_rng(0)
    logits = (3.0 * rng.normal(size=(64, 5))).astype(np.float32)
    logits[0] = [40.0, -40.0, 0.0, 1.0, 2.0]   # a near-deterministic row
    key = jax.random.PRNGKey(1)
    ref_action = jax_d.categorical_sample(key, logits)
    gumbel = torch.tensor(np.asarray(jax.random.gumbel(key, logits.shape)))
    action = D.categorical_sample(torch.tensor(logits), noise=gumbel)
    assert action.dtype == torch.int32
    np.testing.assert_array_equal(action.numpy(), np.asarray(ref_action))
    _close(D.categorical_log_prob(torch.tensor(logits), action), jax_d.categorical_log_prob(logits, ref_action),
           1e-6, "log_prob")
    _close(D.categorical_entropy(torch.tensor(logits)), jax_d.categorical_entropy(logits), 1e-6, "entropy")
    drawn = D.categorical_sample(torch.tensor(logits), generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (64,) and ((drawn >= 0) & (drawn < 5)).all()


@pytest.mark.parametrize("v_min,v_max,nr_bins", [(-10.0, 10.0, 101), (0.0, 500.0, 51)])
def test_hl_gauss_ops_match_jax(v_min, v_max, nr_bins):
    """Values inside the support, on its ends and far outside (the clipped
    mass is renormalized, floored at 1e-8); expectations over the bin
    centres.  f32 on both sides with the same normal CDF: 1e-6."""
    from rlx_tpu.ops import distributional as jax_ops

    rng = np.random.default_rng(2)
    span = v_max - v_min
    values = rng.uniform(v_min - 0.2 * span, v_max + 0.2 * span, size=(6, 7)).astype(np.float32)
    values[0, :4] = [v_min, v_max, 0.5 * (v_min + v_max), v_max + 10.0 * span]
    _close(hl_gauss_targets(torch.tensor(values), v_min, v_max, nr_bins),
           jax_ops.hl_gauss_targets(jnp.asarray(values), v_min, v_max, nr_bins), 1e-6, "targets")
    logits = rng.normal(size=(5, 3, nr_bins)).astype(np.float32)
    _close(hl_gauss_expectation(torch.tensor(logits), v_min, v_max),
           jax_ops.hl_gauss_expectation(jnp.asarray(logits), v_min, v_max), 1e-6 * span, "expectation")


@pytest.mark.parametrize("atoms,layer_norm_all", [(1, False), (51, False), (1, True)])
def test_discrete_q_net_matches_flax(atoms, layer_norm_all):
    """Converted flax parameters give flax's outputs (f32, 1e-5), ``[B, A]``
    or ``[B, A, atoms]``; a net built for flat observations refuses images
    (the image nets are ``tests/test_torch_image_nets.py``'s)."""
    from rlx_tpu.models.mlp import DiscreteQNet as JaxDiscreteQNet

    jnet = JaxDiscreteQNet(nr_actions=3, hidden_sizes=HIDDEN, output_dim_per_action=atoms,
                           layer_norm_all=layer_norm_all)
    obs = np.random.default_rng(3).normal(size=(9, OBS)).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(0), obs)
    net = DiscreteQNet(OBS, 3, HIDDEN, output_dim_per_action=atoms, layer_norm_all=layer_norm_all)
    state = convert.discrete_q_net_state_dict(_np_tree(params), layer_norm_all=layer_norm_all)
    assert set(state) == set(net.state_dict())
    net.load_state_dict(state)
    with torch.no_grad():
        out = net(torch.tensor(obs))
    assert out.shape == ((9, 3) if atoms == 1 else (9, 3, atoms))
    _close(out, jnet.apply(params, obs), 1e-5, "q-values")
    with pytest.raises(ValueError):
        net(torch.zeros(2, 8, 8, 3))


def test_categorical_policy_matches_flax_and_keeps_an_f32_head():
    from rlx_tpu.models.mlp import CategoricalPolicy as JaxCategoricalPolicy

    jnet = JaxCategoricalPolicy(nr_actions=3, hidden_sizes=HIDDEN, activation="elu", layer_norm=True)
    obs = np.random.default_rng(4).normal(size=(9, OBS)).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(1), obs)
    net = CategoricalPolicy(OBS, 3, HIDDEN, "elu", layer_norm=True)
    net.load_state_dict(convert.categorical_policy_state_dict(_np_tree(params)))
    with torch.no_grad():
        _close(net(torch.tensor(obs)), jnet.apply(params, obs), 1e-5, "logits")
    bf16 = CategoricalPolicy(OBS, 3, HIDDEN, "elu", layer_norm=True, compute_dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    assert bf16(torch.tensor(obs)).dtype == torch.float32
    # the head's orthogonal(0.01) init: rows of norm 0.01
    head = CategoricalPolicy(OBS, 3, HIDDEN).logits
    torch.testing.assert_close(head.weight.norm(dim=1), torch.full((3,), 0.01))
    assert (head.bias == 0).all()


@pytest.mark.parametrize("algorithm", FAMILY)
def test_three_updates_match_jax(algorithm):
    """Steps 0-2 on converted parameters and the same batches; JAX's flax
    step counter moves every call, its Adam count (and the port's) only on
    the update steps.  f32 on both sides; Adam's first steps move each
    weight by ~lr: 1e-5."""
    jmodel, model = _models(algorithm)
    assert (model.update_every, model.target_update_every) == (2, 3)
    states = jmodel.states
    _assert_critic_matches(model, states["critic"], 0.0, "converted")
    rng = np.random.default_rng(7)
    jupdate = jax.jit(jmodel.update)
    for step in (0, 1, 2):
        batch = _batch(rng, atom_rows=3)
        before = {k: v.clone() for k, v in model.critic.target.state_dict().items()}
        states, jmetrics = jupdate(states, batch, jax.random.PRNGKey(30 + step), step)
        metrics = model.update({k: torch.tensor(v) for k, v in batch.items()}, step)
        assert set(metrics) == set(jmetrics)
        for k in jmetrics:
            _close(float(metrics[k]), float(jmetrics[k]), 1e-5, f"step {step}: {k}")
        _assert_critic_matches(model, states["critic"], 1e-5, f"after step {step}")
        copied = any(not torch.equal(before[k], v) for k, v in model.critic.target.state_dict().items())
        assert copied == (step == 0), step
    assert int(states["critic"].step) == 3
    assert model.critic.step_count() == int(states["critic"].opt_state.inner_state[0].count) == 2


def test_c51_target_goes_through_the_dense_projection(monkeypatch):
    """The port's C51 target is ``categorical_projection_dense`` (its plain
    version on the CPU) of the same positions and masses as JAX's, on a
    batch with rows on atoms and rows clipped to both ends: inputs at 1e-6,
    the projected distribution at 1e-6."""
    import rlx_tpu.algorithms.c51.tpu.c51 as jax_c51

    import rlx_tpu_torch.algorithms.c51.cuda.c51 as c51

    calls = {"jax": [], "port": []}

    def record(side, *arrays):
        calls[side].append(tuple(np.asarray(a) for a in arrays))

    def spy(side, fn):
        def wrapped(target_z, probs, v_min, v_max, nr_atoms):
            out = fn(target_z, probs, v_min, v_max, nr_atoms)
            if side == "jax":   # traced under jit: record when the program runs
                jax.debug.callback(lambda *a: record(side, *a), target_z, probs, out)
            else:
                record(side, target_z, probs, out)
            return out
        return wrapped

    monkeypatch.setattr(jax_c51, "categorical_projection", spy("jax", jax_c51.categorical_projection))
    monkeypatch.setattr(c51, "categorical_projection_dense", spy("port", c51.categorical_projection_dense))
    jmodel, model = _models("c51")
    batch = _batch(np.random.default_rng(9), atom_rows=4)
    jax.block_until_ready(jax.jit(jmodel.update)(jmodel.states, batch, jax.random.PRNGKey(0), 1))
    model.update({k: torch.tensor(v) for k, v in batch.items()}, 1)
    (jz, jp, jout), = calls["jax"]
    (z, p, out), = calls["port"]
    _close(z, jz, 1e-6, "target positions")
    _close(p, jp, 1e-6, "best-action masses")
    _close(out, jout, 1e-6, "projected target")
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(out[:4, 25], 1.0, atol=1e-6)   # reward 0, terminated: all mass on atom 0.0


@pytest.mark.parametrize("algorithm", FAMILY)
def test_act_and_eval_act_match_jax(algorithm):
    """Greedy actions, and epsilon-greedy at step 40 of 80 (epsilon ~0.5)
    with JAX's random actions and uniforms replayed."""
    jmodel, model = _models(algorithm)
    obs = (2.0 * np.random.default_rng(5).normal(size=(8, OBS))).astype(np.float32)
    key = jax.random.PRNGKey(4)
    _, explore_key, pick_key = jax.random.split(key, 3)
    draws = {
        "random_action": torch.tensor(np.asarray(jax.random.randint(explore_key, (8,), 0, ACTIONS, jnp.int32))),
        "draw": torch.tensor(np.asarray(jax.random.uniform(pick_key, (8,)))),
    }
    action = model.act(torch.tensor(obs), 40, **draws)
    assert action.dtype == torch.int32
    np.testing.assert_array_equal(action.numpy(), np.asarray(jmodel.act(jmodel.states, obs, key, 40)))
    np.testing.assert_array_equal(model.eval_act(torch.tensor(obs)).numpy(),
                                  np.asarray(jmodel.eval_act(jmodel.states, obs)))
    _close(model.epsilon(40), jmodel.epsilon(40), 1e-6, "epsilon")


@pytest.mark.parametrize("algorithm", FAMILY)
def test_trains_with_the_jax_sizing(algorithm):
    overrides = {**SMALL, **TRAIN, "algorithm.evaluation_active": True}
    model = create_model(make_config(f"{algorithm}.cuda", "classic.cart_pole.cuda", **overrides,
                                     **{"runner.device": "cpu"}))
    jmodel = _jax_model(algorithm, overrides)
    assert [getattr(model, k) for k in SIZING] == [getattr(jmodel, k) for k in SIZING]
    initial = [p.detach().clone() for p in model.critic.module.parameters()]
    model.train()
    assert any(not torch.equal(a, b) for a, b in zip(initial, model.critic.module.parameters()))
    assert all(torch.isfinite(p).all() for p in model.critic.module.parameters())
    # 16 prefill steps, then 24 learning steps in 3 log lines of 8; an Adam
    # step on every other learning step
    assert model.prefill_iterations == 16 and model.nr_updates == 24
    assert model.critic.step_count() == 12
    assert [m["steps/nr_updates"] for m in model.metrics_history] == [8, 16, 24]
    assert all(np.isfinite(v) for m in model.metrics_history for v in m.values())
    assert list(model.eval_history["steps"]) == [320]
    assert model.buffer.data["action"].dtype == torch.int32


@pytest.mark.parametrize("algorithm", [*FAMILY, "pqn"])
def test_jax_checkpoint_carries_into_the_port(algorithm, tmp_path):
    """The key set of a JAX ``latest.model`` is the port's, and its
    parameters (and targets, set apart from the parameters) give the port
    JAX's Q-values."""
    from rlx_tpu.utils.checkpoint import load_model_file

    overrides = {"environment.nr_envs": 8, "algorithm.critic_hidden_sizes": HIDDEN}
    jmodel = _jax_model(algorithm, {**overrides, "runner.save_model": True}, run_path=str(tmp_path / "jax"))
    if algorithm == "pqn":
        params = jmodel.critic_state.params
    else:
        critic = jmodel.states["critic"]
        jmodel.states = {"critic": critic.replace(target_params=jax.tree.map(lambda x: -x, critic.params))}
        params = critic.params
    jmodel.save()
    restored, _ = load_model_file(str(tmp_path / "jax" / "models" / "latest.model"))
    port = create_model(make_config(f"{algorithm}.cuda", "classic.cart_pole.cuda", **overrides,
                                    **{"runner.device": "cpu"}))
    expected_keys = {"critic"} if algorithm == "pqn" else {"critic", "critic_target"}
    assert set(port.checkpoint_tree()) == set(restored) == expected_keys
    port.restore_from_tree(convert.checkpoint_tree_from_jax(algorithm, _np_tree(restored)))
    obs = (2.0 * np.random.default_rng(2).normal(size=(32, OBS))).astype(np.float32)
    ours = port.q_net if algorithm == "pqn" else port.critic.module
    with torch.no_grad():
        _close(ours(torch.tensor(obs)), jmodel.q_net.apply(params, obs), 1e-5, "q-values")
        if algorithm != "pqn":
            _close(port.critic.target(torch.tensor(obs)),
                   jmodel.q_net.apply(jmodel.states["critic"].target_params, obs), 1e-5, "target q-values")


def test_jax_discrete_ppo_checkpoint_carries_into_the_port(tmp_path):
    """A JAX PPO ``latest.model`` from CartPole holds a ``CategoricalPolicy``
    (no ``policy_logstd``): carried across, the port's logits and values are
    JAX's."""
    from rlx_tpu.utils.checkpoint import load_model_file

    overrides = {"environment.nr_envs": 8, "algorithm.nr_steps": 4, "algorithm.minibatch_size": 8,
                 "algorithm.policy_hidden_sizes": HIDDEN, "algorithm.critic_hidden_sizes": HIDDEN}
    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config

    jmodel = jax_create_model(jax_make_config("ppo.tpu", "classic.cart_pole.tpu", **overrides, **{
        "runner.mesh_dp": 1, "runner.save_model": True}), run_path=str(tmp_path))
    jmodel.save()
    restored, _ = load_model_file(str(tmp_path / "models" / "latest.model"))
    port = create_model(make_config("ppo.cuda", "classic.cart_pole.cuda", **overrides, **{"runner.device": "cpu"}))
    port.restore_from_tree(convert.checkpoint_tree_from_jax("ppo", _np_tree(restored)))
    obs = (2.0 * np.random.default_rng(3).normal(size=(16, OBS))).astype(np.float32)
    with torch.no_grad():
        _close(port.policy.module(torch.tensor(obs)), jmodel.policy.module.apply(jmodel.policy_state.params, obs),
               1e-5, "logits")
        _close(port.critic(torch.tensor(obs)), jmodel.critic.apply(jmodel.critic_state.params, obs), 1e-5, "values")


@pytest.mark.parametrize("environment", ["classic.pixel_grid.cuda", "classic.pixel_chase.cuda"])
def test_image_families_accepted_and_the_rest_refused(environment):
    """The six families whose JAX counterparts list IMAGES pass the runner's
    compatibility check on both pixel envs and build NatureCNN nets there;
    a family whose JAX counterpart lists flat values only (SAC) is still
    refused."""
    from rlx_tpu_torch.algorithms.algorithm_manager import get_algorithm_general_properties
    from rlx_tpu_torch.environments.environment_manager import get_environment_general_properties
    from types import SimpleNamespace

    from rlx_tpu_torch.environments.types import ActionSpaceType, ObservationSpaceType
    from rlx_tpu_torch.runner.runner import Runner

    for algorithm in (*FAMILY, "pqn", "ppo"):
        runner = Runner([f"--algorithm.name={algorithm}.cuda", f"--environment.name={environment}",
                         "--runner.device=cpu", "--environment.nr_envs=2"])
        assert ObservationSpaceType.IMAGES in get_algorithm_general_properties(f"{algorithm}.cuda").observation_space_types
        model = create_model(runner.config)
        nets = [model.policy.module, model.critic] if algorithm == "ppo" else (
            [model.q_net] if algorithm == "pqn" else [model.critic.module])
        assert all(any(name.startswith("trunk.convs.") for name in net.state_dict()) for net in nets), algorithm
    # SAC on images with continuous actions: refused for the observations;
    # on the pixel envs (discrete actions) the runner refuses it too
    make_config("sac.cuda", environment, **{"runner.device": "cpu"})
    continuous_images = SimpleNamespace(**{**vars(get_environment_general_properties(environment)),
                                           "action_space_type": ActionSpaceType.CONTINUOUS})
    with pytest.raises(ValueError, match="observation space"):
        Runner.check_compatibility(get_algorithm_general_properties("sac.cuda"), continuous_images)
    with pytest.raises(ValueError, match="action space"):
        Runner(["--algorithm.name=sac.cuda", f"--environment.name={environment}", "--runner.device=cpu"])


def test_left_out_features_raise():
    for algorithm in (*FAMILY, "pqn"):   # parallel seeds are ported: the key is there
        config = make_config(f"{algorithm}.cuda", "classic.cart_pole.cuda", **{"algorithm.nr_parallel_seeds": 2})
        assert config.algorithm.nr_parallel_seeds == 2
    with pytest.raises(KeyError):
        make_config("dqn.cuda", "classic.cart_pole.cuda", **{"algorithm.shard_local_sampling": False})


def test_curve_recipes_match_jax():
    """The port's learning checks run the JAX package's recipes: budget,
    threshold, direction, evaluation points, overrides and metric, name for
    name, the host envs' two among them."""
    from rlx_tpu_torch.benchmarks.curves import RUNS

    spec = importlib.util.spec_from_file_location("jax_curves", os.path.join(REPO, "benchmarks", "curves.py"))
    jax_curves = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_curves)
    fields = lambda r: (r["budget"], r["threshold"], r["eval_points"], r.get("expect", "above"), r["overrides"],
                        r.get("metric", "eval/episode_return"))
    for name, run in RUNS.items():
        ref = jax_curves.RUNS[name]
        assert run["algorithm"] == ref["algorithm"].replace(".tpu", ".cuda"), name
        assert run["environment"] == ref["environment"].replace(".tpu", ".cuda"), name
        assert fields(run) == fields(ref), name
    assert {f"cartpole_spot_{n}" for n in (*FAMILY, "pqn")} <= set(RUNS)
    assert {"locomotion_ppo", "locomotion_lstm", "locomotion_ppo_bf16", "soccer_lstm"} <= set(RUNS)
    # the host envs' recipes, run on the CPU as JAX's records were
    assert {name for name, run in RUNS.items() if run.get("device") == "cpu"} == {"hopper_ppo",
                                                                                 "dmc_walker_walk_sac"}
    assert {f"pendulum_masked_{n}" for n in ("ppo", "history_window", "memory_actions", "lstm", "gru", "mamba2",
                                             "transformer")} <= set(RUNS)
    assert {f"pendulum_spot_{n}" for n in ("fastsac", "flashsac", "redq", "droq", "aqe", "tqc", "simba", "xqc",
                                           "simbav2", "crossq", "bro", "mpo", "fastmpo", "espo", "ppo_dtrl",
                                           "reppo")} <= set(RUNS)
