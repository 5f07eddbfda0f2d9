"""Parallel seeds against the JAX package, on the CPU: one seed-batched
update of the port at S = 2 against JAX's one-seed update for each seed,
from that seed's converted parameters, batch and draws (JAX's vmapped
program runs each seed as its one-seed program):

- PPO's ``_optimize`` with ``epoch_indices [S, E, N]`` (per-seed
  permutations, per-seed advantage normalization, per-seed clip);
- SAC's ``update_seeds`` with JAX's normals replayed;
- C51's ``update_seeds``: both seeds' targets through one projection
  (kernel B3's plain version on the CPU).

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


def _offpolicy_pair(algorithm, environment, overrides, state_dicts):
    """(JAX model, per-seed JAX states, port model at S = 2 loaded with them)."""
    jmodel = jax_create_model(jax_make_config(f"{algorithm}.tpu", f"{environment}.tpu", **overrides,
                                              **{"runner.mesh_dp": 1}))
    states = [jmodel.states, jmodel.setup_states()]
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
