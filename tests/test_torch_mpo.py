"""The port's MPO against the JAX package's: ``update`` over two steps
from n-step batches on the Ant's shapes (34-d observations, 8-d actions),
with a running normalizer and the parameters carried from JAX by
``convert.checkpoint_tree_from_jax`` and JAX's normals injected; every
metric and every state of the checkpoint after each step (1e-5).  The
first step refreshes both targets, the second neither; the duals start
below their floors, so that the clamp engages."""

import numpy as np
import torch

from rlx_tpu_torch import convert
from torch_parity import assert_tree_close, batch, close, models, normals, np_tree, to_torch
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

B = 16


def _carried(algorithm, jmodel, states):
    return convert.checkpoint_tree_from_jax(algorithm, np_tree(jmodel.checkpoint_tree(states)))


MPO = {"environment.nr_envs": 8, "algorithm.batch_size": B, "algorithm.policy_hidden_sizes": (16, 16),
       "algorithm.critic_hidden_sizes": (16, 16), "algorithm.action_sampling_number": 3, "algorithm.nr_atoms": 11,
       "algorithm.v_min": -20.0, "algorithm.v_max": 20.0, "algorithm.enable_observation_normalization": True,
       "algorithm.evaluation_active": False}


def _nstep_batch(rng, obs_dim, action_dim):
    data = batch(rng, B, obs_dim, action_dim, scale=2.0)
    data["action"] *= 1.5     # some actions outside [-1, 1]
    data["n_step_next_observation"] = (2.0 * rng.normal(size=(B, obs_dim))).astype(np.float32)
    data["n_step_reward"] = (3.0 * rng.normal(size=B)).astype(np.float32)
    data["n_step_terminated"] = data["terminated"]
    data["n_step_gamma"] = (0.99 ** rng.integers(1, 5, size=B)).astype(np.float32)
    return data


def test_mpo_two_updates_and_the_dual_clamp_match_jax():
    """The first update refreshes both targets (step 0), the second neither;
    ``log_eta`` and ``log_alpha_mean`` start 7 below their floor of -18,
    beyond one Adam step, so both packages clamp them to -18 after it."""
    import jax
    import jax.numpy as jnp

    jmodel, model = models("mpo", {**MPO, "environment.nr_envs": 4}, "locomotion.ant")
    states = dict(jmodel.states)
    rng = np.random.default_rng(5)
    states["obs_normalizer"] = {"mean": jnp.asarray(rng.normal(size=34), jnp.float32),
                                "var": jnp.asarray(rng.uniform(0.5, 4, size=34), jnp.float32),
                                "count": jnp.asarray(50.0)}
    duals = states["duals"].params["params"]
    states["duals"] = states["duals"].replace(params={"params": {
        **duals, "log_eta": jnp.asarray(-25.0), "log_alpha_mean": jnp.full_like(duals["log_alpha_mean"], -25.0)}})
    model.restore_from_tree(_carried("mpo", jmodel, states))
    jupdate = jax.jit(jmodel.update)
    for step in (0, 1):
        data = _nstep_batch(rng, 34, 8)
        key = jax.random.PRNGKey(70 + step)
        states, jmetrics = jupdate(states, data, key, step)
        critic_key, estep_key = jax.random.split(key)
        metrics = model.update(to_torch(data), step, critic_noise=normals(critic_key, (3, B, 8)),
                               estep_noise=normals(estep_key, (3, 2 * B, 8)))
        assert set(metrics) == set(jmetrics)
        for k in jmetrics:
            close(float(metrics[k]), float(jmetrics[k]), 1e-5, f"step {step}: {k}")
        assert_tree_close(model.checkpoint_tree(), _carried("mpo", jmodel, states), 1e-5, f"after step {step}")
        if step == 0:
            assert model.duals.module.log_eta.item() == -18.0
            assert model.duals.module.log_alpha_mean.tolist() == [-18.0] * 8
    # step 1 refreshed no target: the targets are step 0's parameters
    assert not torch.equal(model.critic.target.head.weight, model.critic.module.head.weight)
