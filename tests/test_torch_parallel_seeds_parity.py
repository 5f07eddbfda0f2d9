"""Parallel seeds against the JAX package, on the CPU: one seed-batched
update of the port at S = 2 against JAX's one-seed update for each seed,
from that seed's converted parameters, batch and draws (JAX's vmapped
program runs each seed as its one-seed program):

- PPO's ``_optimize`` with ``epoch_indices [S, E, N]`` (per-seed
  permutations, per-seed advantage normalization, per-seed clip);
- SAC's ``update_seeds`` with JAX's normals replayed;
- C51's ``update_seeds``: both seeds' targets through one projection
  (kernel B3's plain version on the CPU);
- FlashSAC's ``update_seeds``: parameters and the three BatchNorm streams'
  running statistics, per-seed reward normalizers, both seeds' targets
  through one projection;
- REDQ's ``update_with_buffer``: per-seed batches, normals and critic
  subsets over several critic steps (the JAX loop's draws recomputed from
  its keys, as ``test_torch_ensembles.py`` does);
- MPO's ``update_seeds``: per-seed E-step samples, duals (one seed's
  starting below their floor) and normalizers.

f32 on both sides at the one-seed tests' tolerances: 1e-5 on parameters
(Adam's first steps move each weight by ~lr), metrics as those tests.  On
Pendulum and CartPole: the JAX Ant's set-up alone costs ~16 s here."""

import jax
import numpy as np
import torch

from rlx_tpu.config import create_model as jax_create_model
from rlx_tpu.config import make_config as jax_make_config
from rlx_tpu_torch import convert
from rlx_tpu_torch.config import create_model, make_config
from torch_parity import assert_tree_close
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

S = 2


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _stacked(state_dicts):
    """One seed-stacked state dict from per-seed ones."""
    return {k: torch.stack([sd[k] for sd in state_dicts]) for k in state_dicts[0]}


def _assert_seed(module, s, ref, tol, what):
    got = module.state_dict()
    assert set(got) == set(ref), what
    for key in ref:
        torch.testing.assert_close(got[key][s], ref[key], rtol=tol, atol=tol, msg=lambda m: f"{what} {key}: {m}")


def _port(algorithm, environment, overrides):
    return create_model(make_config(f"{algorithm}.cuda", f"{environment}.cuda", **{
        **overrides, "runner.device": "cpu", "algorithm.nr_parallel_seeds": S, "algorithm.logging_active": False}))


def test_ppo_optimize_matches_jax_per_seed():
    from test_torch_ppo import EPOCHS, MINIBATCH, NR_ENVS, NR_STEPS, SHARED

    jmodel = jax_create_model(jax_make_config("ppo.tpu", "classic.pendulum.tpu", **SHARED, **{
        "runner.mesh_dp": 1, "algorithm.evaluation_active": False}))
    model = _port("ppo", "classic.pendulum", SHARED)
    # seed 1 starts from other parameters than seed 0
    scale = lambda tree: jax.tree.map(lambda x: 0.7 * x + 0.01, tree)
    policy_states = [jmodel.policy_state, jmodel.policy_state.replace(params=scale(jmodel.policy_state.params))]
    critic_states = [jmodel.critic_state, jmodel.critic_state.replace(params=scale(jmodel.critic_state.params))]
    model.policy.module.load_state_dict(_stacked([convert.policy_state_dict(_np_tree(p.params))
                                                  for p in policy_states]))
    model.critic.load_state_dict(_stacked([convert.critic_state_dict(_np_tree(c.params)) for c in critic_states]))

    N = NR_ENVS * NR_STEPS
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(N, 3)).astype(np.float32), rng.normal(size=(N, 1)).astype(np.float32),
                rng.normal(size=N).astype(np.float32) - 8.0, rng.normal(size=N).astype(np.float32),
                (s + 1.0) * rng.normal(size=N).astype(np.float32)) for s in range(S)]
    refs, epoch_indices = [], []
    for s in range(S):
        key = jax.random.PRNGKey(7 + s)
        _, perm_key = jax.random.split(key)
        epoch_indices.append(np.asarray(jax.random.permutation(
            perm_key, np.tile(np.arange(N), (EPOCHS, 1)), axis=1, independent=True)))
        refs.append(jmodel._optimize(policy_states[s], critic_states[s], batches[s], key))
    metrics = model._optimize(tuple(torch.tensor(np.stack(x)) for x in zip(*batches)),
                              epoch_indices=torch.tensor(np.stack(epoch_indices)))
    for s, (policy_state, critic_state, jmetrics) in enumerate(refs):
        _assert_seed(model.policy.module, s, convert.policy_state_dict(_np_tree(policy_state.params)), 1e-5,
                     f"seed {s} policy")
        _assert_seed(model.critic, s, convert.critic_state_dict(_np_tree(critic_state.params)), 1e-5,
                     f"seed {s} critic")
        assert set(metrics) == set(jmetrics)
        for k in jmetrics:
            ours = metrics[k] if metrics[k].ndim == 0 else metrics[k][s]
            np.testing.assert_allclose(float(ours), float(jmetrics[k]), rtol=1e-4, atol=1e-5, err_msg=f"{s} {k}")
    assert model.nr_optimizer_steps == EPOCHS * N // MINIBATCH


def _other_seed(states):
    """Seed 1's states: seed 0's with every float of the networks'
    parameters, running statistics and dict states (normalizers, noise)
    moved (``0.7 x + 0.01``), the optimizers' states as they are; the arrays
    keep their types and placement, so a jitted JAX update runs them without
    compiling again."""
    import jax.numpy as jnp

    move = lambda tree: jax.tree.map(lambda x: 0.7 * x + 0.01 if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)
    out = {}
    for name, state in states.items():
        if hasattr(state, "params"):
            fields = ("params", "target_params", "batch_stats", "target_batch_stats")
            out[name] = state.replace(**{f: move(getattr(state, f)) for f in fields
                                         if getattr(state, f, None) is not None})
        else:
            out[name] = move(state)
    return out


def _offpolicy_pair(algorithm, environment, overrides, state_dicts):
    """(JAX model, per-seed JAX states, port model at S = 2 loaded with them)."""
    jmodel = jax_create_model(jax_make_config(f"{algorithm}.tpu", f"{environment}.tpu", **overrides,
                                              **{"runner.mesh_dp": 1}))
    states = [jmodel.states, _other_seed(jmodel.states)]
    model = _port(algorithm, environment, overrides)
    for name, field, module, to_torch in state_dicts(model):
        module.load_state_dict(_stacked([to_torch(_np_tree(getattr(st[name], field))) for st in states]))
    return jmodel, states, model


def _sac_state_dicts(model):
    return (("policy", "params", model.policy.module, convert.squashed_gaussian_policy_state_dict),
            ("critic", "params", model.critic.module, convert.vector_q_critic_state_dict),
            ("critic", "target_params", model.critic.target, convert.vector_q_critic_state_dict),
            ("alpha", "params", model.alpha.module, convert.entropy_coefficient_state_dict))


def test_sac_update_matches_jax_per_seed():
    from test_torch_sac import SMALL
    from torch_parity import batch

    B, OBS, ACT = 32, 3, 1
    overrides = {**SMALL, "algorithm.total_timesteps": 320, "algorithm.learning_starts": 64}
    jmodel, states, model = _offpolicy_pair("sac", "classic.pendulum", overrides, _sac_state_dicts)
    rng = np.random.default_rng(3)
    batches = [batch(rng, B, OBS, ACT, scale=3.0) for _ in range(S)]
    jupdate = jax.jit(jmodel.update)
    refs, noises = [], []
    for s in range(S):
        key = jax.random.PRNGKey(40 + s)
        refs.append(jupdate(states[s], batches[s], key, 0))
        noises.append([torch.tensor(np.asarray(jax.random.normal(k, (B, ACT)))) for k in jax.random.split(key)])
    target_noise, current_noise = (torch.stack(x) for x in zip(*noises))
    metrics = model.update_seeds({k: torch.tensor(np.stack([b[k] for b in batches])) for k in batches[0]}, 0,
                                 target_noise, current_noise)
    for s, (new_states, jmetrics) in enumerate(refs):
        for name, field, module, to_torch in _sac_state_dicts(model):
            _assert_seed(module, s, to_torch(_np_tree(getattr(new_states[name], field))), 1e-5,
                         f"seed {s} {name}.{field}")
        assert set(metrics) == set(jmetrics)
        for k in jmetrics:
            ours = metrics[k] if metrics[k].ndim == 0 else metrics[k][s]
            np.testing.assert_allclose(float(ours), float(jmetrics[k]), rtol=1e-5, atol=1e-5, err_msg=f"{s} {k}")


def test_c51_update_matches_jax_per_seed(monkeypatch):
    """Both seeds' targets go through ONE projection call at ``[S * B,
    atoms]`` (kernel B3 on the card, its plain version here)."""
    from rlx_tpu_torch.algorithms.c51.cuda import c51
    from test_torch_discrete import SMALL, _batch

    state_dicts = lambda model: (
        ("critic", "params", model.critic.module, convert.discrete_q_net_state_dict),
        ("critic", "target_params", model.critic.target, convert.discrete_q_net_state_dict))
    jmodel, states, model = _offpolicy_pair("c51", "classic.cart_pole", SMALL, state_dicts)
    shapes = []
    projection = c51.categorical_projection_dense
    monkeypatch.setattr(c51, "categorical_projection_dense",
                        lambda z, p, *a: shapes.append(tuple(z.shape)) or projection(z, p, *a))
    rng = np.random.default_rng(5)
    batches = [_batch(rng, atom_rows=3) for _ in range(S)]
    jupdate = jax.jit(jmodel.update)
    refs = [jupdate(states[s], batches[s], jax.random.PRNGKey(30 + s), 0) for s in range(S)]
    metrics = model.update_seeds({k: torch.tensor(np.stack([b[k] for b in batches])) for k in batches[0]}, 0)
    assert shapes == [(S * batches[0]["reward"].shape[0], model.nr_atoms)]
    for s, (new_states, jmetrics) in enumerate(refs):
        for name, field, module, to_torch in state_dicts(model):
            _assert_seed(module, s, to_torch(_np_tree(getattr(new_states[name], field))), 1e-5,
                         f"seed {s} {name}.{field}")
        for k in jmetrics:
            ours = metrics[k] if metrics[k].ndim == 0 else metrics[k][s]
            np.testing.assert_allclose(float(ours), float(jmetrics[k]), rtol=1e-5, atol=1e-5, err_msg=f"{s} {k}")


def _stack_trees(trees):
    """One seed-stacked tree from per-seed nested dicts of tensors."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack([torch.as_tensor(t) for t in trees])


def _seed_tree(tree, s):
    """Seed ``s``'s slice of a seed-stacked tree."""
    if isinstance(tree, dict):
        return {k: _seed_tree(v, s) for k, v in tree.items()}
    return tree[s]


def _carried(algorithm, jmodel, states):
    return convert.checkpoint_tree_from_jax(algorithm, _np_tree(jmodel.checkpoint_tree(states)))


def _metrics_close(metrics, jmetrics, s, tol):
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        ours = metrics[k] if metrics[k].ndim == 0 else metrics[k][s]
        np.testing.assert_allclose(float(ours), float(jmetrics[k]), rtol=tol, atol=tol, err_msg=f"{s} {k}")


def test_flashsac_update_matches_jax_per_seed(monkeypatch):
    """Parameters and running statistics of the policy, the critic and its
    target per seed at 1e-5, seed 1 with a non-trivial reward normalizer;
    one projection call at ``[S * B, atoms]``."""
    import jax.numpy as jnp

    from rlx_tpu_torch.algorithms.flashsac.cuda import flashsac
    from test_torch_flashsac import SMALL
    from torch_parity import batch

    B, OBS, ACT = SMALL["algorithm.batch_size"], 3, 1
    jmodel = jax_create_model(jax_make_config("flashsac.tpu", "classic.pendulum.tpu", **SMALL, **{"runner.mesh_dp": 1}))
    states = [dict(jmodel.states), dict(_other_seed(jmodel.states))]
    normalizer = states[1]["reward_normalizer"]
    states[1]["reward_normalizer"] = {**normalizer, "var": jnp.full_like(normalizer["var"], 4.0),
                                      "g_max": jnp.full_like(normalizer["g_max"], 30.0)}
    model = _port("flashsac", "classic.pendulum", SMALL)
    model.restore_from_tree(_stack_trees([_carried("flashsac", jmodel, st) for st in states]))
    shapes = []
    projection = flashsac.categorical_projection_dense
    monkeypatch.setattr(flashsac, "categorical_projection_dense",
                        lambda z, p, *a: shapes.append(tuple(z.shape)) or projection(z, p, *a))
    rng = np.random.default_rng(2)
    batches = [batch(rng, B, OBS, ACT, scale=2.0) for _ in range(S)]
    jupdate = jax.jit(jmodel.update)
    refs, noises = [], []
    for s in range(S):
        key = jax.random.PRNGKey(30 + s)
        refs.append(jupdate(states[s], batches[s], key, 0))
        noises.append([torch.tensor(np.asarray(jax.random.normal(k, (B, ACT)))) for k in jax.random.split(key)])
    policy_noise, target_noise = (torch.stack(x) for x in zip(*noises))
    metrics = model.update_seeds({k: torch.tensor(np.stack([b[k] for b in batches])) for k in batches[0]}, 0,
                                 policy_noise, target_noise)
    assert shapes == [(S * B, model.nr_atoms)]
    ours = model.checkpoint_tree()
    for s, (new_states, jmetrics) in enumerate(refs):
        assert_tree_close(_seed_tree(ours, s), _carried("flashsac", jmodel, new_states), 1e-5, f"seed {s}")
        _metrics_close(metrics, jmetrics, s, 1e-5)


def test_redq_update_with_buffer_matches_jax_per_seed():
    """Per-seed batches, normals and subsets over ``Q_STEPS`` critic steps
    and the policy step, from each seed's JAX draws."""
    from rlx_tpu.ops import replay_buffer as jrb
    from test_torch_ensembles import B, ENSEMBLES, SMALL, _filled_buffer
    from torch_parity import normals

    overrides = {**SMALL, **ENSEMBLES["redq"]}
    state_dicts = lambda model: _sac_state_dicts(model)
    jmodel, states, model = _offpolicy_pair("redq", "classic.pendulum", overrides, state_dicts)
    rng = np.random.default_rng(9)
    buffers = [_filled_buffer(jmodel, rng) for _ in range(S)]
    nr_critics = model.config.algorithm.nr_critics
    refs, batches, critic_draws, policy_draws = [], [], [], []
    jupdate = jax.jit(jmodel.update_with_buffer)
    for s in range(S):
        key = jax.random.PRNGKey(40 + s)
        refs.append(jupdate(states[s], buffers[s], key, 0))
        # the JAX loop's draws, recomputed from its keys
        loop_key, policy_key, policy_sample_key = jax.random.split(key, 3)
        seed_batches, seed_draws = [], []
        for step_key in jax.random.split(loop_key, model.q_update_steps):
            sample_key, update_key = jax.random.split(step_key)
            seed_batches.append(_np_tree(jrb.sample(buffers[s], sample_key, B)))
            target_key, subset_key, _, _ = jax.random.split(update_key, 4)
            seed_draws.append({"target_noise": normals(target_key, (B, 1)), "subset": torch.tensor(
                np.asarray(jax.random.choice(subset_key, nr_critics, (2,), replace=False)))})
        seed_batches.append(_np_tree(jrb.sample(buffers[s], policy_sample_key, B)))
        batches.append(seed_batches)
        critic_draws.append(seed_draws)
        policy_draws.append(normals(jax.random.split(policy_key)[0], (B, 1)))
    stacked_batches = iter([{k: torch.tensor(np.stack([b[i][k] for b in batches])) for k in batches[0][i]}
                            for i in range(len(batches[0]))])
    stacked_draws = iter([_stack_trees([critic_draws[s][i] for s in range(S)])
                          for i in range(model.q_update_steps)])
    critic_update, policy_alpha_update = model.critic_update, model.policy_alpha_update
    model.sample_batch = lambda _: next(stacked_batches)
    model.critic_update = lambda b: critic_update(b, **next(stacked_draws))
    model.policy_alpha_update = lambda b: policy_alpha_update(b, current_noise=torch.stack(policy_draws))
    metrics = model.update_with_buffer(None, 0)
    for s, (new_states, jmetrics) in enumerate(refs):
        for name, field, module, to_torch in _sac_state_dicts(model):
            _assert_seed(module, s, to_torch(_np_tree(getattr(new_states[name], field))), 1e-5,
                         f"seed {s} {name}.{field}")
        _metrics_close(metrics, jmetrics, s, 1e-5)


def test_mpo_update_matches_jax_per_seed():
    """Per-seed E-step samples and duals: seed 1's ``log_eta`` starts below
    its floor, so its clamp engages and seed 0's does not; each seed's
    observation normalizer."""
    import jax.numpy as jnp

    from test_torch_mpo import MPO, _nstep_batch
    from torch_parity import normals

    B, SAMPLES = MPO["algorithm.batch_size"], MPO["algorithm.action_sampling_number"]
    jmodel = jax_create_model(jax_make_config("mpo.tpu", "classic.pendulum.tpu", **MPO, **{"runner.mesh_dp": 1}))
    rng = np.random.default_rng(5)
    first = dict(jmodel.states)
    first["obs_normalizer"] = {"mean": jnp.asarray(rng.normal(size=3), jnp.float32),
                               "var": jnp.asarray(rng.uniform(0.5, 4, size=3), jnp.float32),
                               "count": jnp.full_like(first["obs_normalizer"]["count"], 50.0)}
    states = [first, dict(_other_seed(first))]
    duals = states[1]["duals"].params["params"]
    states[1]["duals"] = states[1]["duals"].replace(params={"params": {
        **duals, "log_eta": jnp.full_like(duals["log_eta"], -25.0)}})
    model = _port("mpo", "classic.pendulum", MPO)
    model.restore_from_tree(_stack_trees([_carried("mpo", jmodel, st) for st in states]))
    batches = [_nstep_batch(rng, 3, 1) for _ in range(S)]
    jupdate = jax.jit(jmodel.update)
    refs, noises = [], []
    for s in range(S):
        key = jax.random.PRNGKey(70 + s)
        refs.append(jupdate(states[s], batches[s], key, 0))
        critic_key, estep_key = jax.random.split(key)
        noises.append((normals(critic_key, (SAMPLES, B, 1)), normals(estep_key, (SAMPLES, 2 * B, 1))))
    critic_noise, estep_noise = (torch.stack(x) for x in zip(*noises))
    metrics = model.update_seeds({k: torch.tensor(np.stack([b[k] for b in batches])) for k in batches[0]}, 0,
                                 critic_noise, estep_noise)
    ours = model.checkpoint_tree()
    for s, (new_states, jmetrics) in enumerate(refs):
        assert_tree_close(_seed_tree(ours, s), _carried("mpo", jmodel, new_states), 1e-5, f"seed {s}")
        _metrics_close(metrics, jmetrics, s, 1e-5)
    assert model.duals.module.log_eta[1].item() == -18.0 and model.duals.module.log_eta[0].item() > -18.0
