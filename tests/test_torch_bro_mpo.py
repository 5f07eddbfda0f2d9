"""The port's BRO and MPO against the JAX package's:

- BRO's ``update_with_buffer`` over two env steps of 2 critic updates
  each, from a JAX checkpoint tree carried in by
  ``convert.checkpoint_tree_from_jax`` (``init_copy`` included), with the
  batches JAX samples from the same buffer and JAX's normals (target,
  current, optimistic): every metric and every state of the checkpoint
  (1e-5).  The second step is a reset step: the three nets' parameters
  equal ``init_copy`` bit for bit, while the critic's target and the
  critic's Adam moments keep moving as JAX's do;
- MPO's soft projection against the JAX expression (1e-6);
- BRO's, MPO's and FastMPO's defaults.

MPO's updates are held in ``test_torch_mpo.py``; FastMPO's updates, the
action pipeline and the per-env sizing in ``test_torch_fastmpo.py``.
"""

import numpy as np
import torch

from rlx_tpu_torch import convert
from rlx_tpu_torch.config import create_model, make_config
from torch_parity import (adam_moments, assert_tree_close, batch, close, jax_adam_mu, models, normals, np_tree,
                          to_torch)
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

B = 16


def _filled_buffer(jmodel, rng, obs_dim, action_dim, rows=12):
    import jax.numpy as jnp

    from rlx_tpu.ops import replay_buffer as jrb

    buffer = jmodel._make_buffer()
    for _ in range(rows):
        step = batch(rng, jmodel.nr_envs, obs_dim, action_dim, scale=2.0)
        buffer = jrb.add(buffer, {k: jnp.asarray(v) for k, v in step.items()})
    return buffer


def _carried(algorithm, jmodel, states):
    return convert.checkpoint_tree_from_jax(algorithm, np_tree(jmodel.checkpoint_tree(states)))


BRO = {"environment.nr_envs": 8, "algorithm.batch_size": B, "algorithm.policy_hidden_dim": 8,
       "algorithm.critic_hidden_dim": 16, "algorithm.critic_nr_blocks": 1, "algorithm.nr_quantiles": 7,
       "algorithm.updates_per_step": 2, "algorithm.pessimism": 0.3, "algorithm.first_reset_step": 8,
       "algorithm.reset_interval": 10**6, "algorithm.evaluation_active": False}


def test_bro_update_with_buffer_and_reset_match_jax():
    import jax

    from rlx_tpu.ops import replay_buffer as jrb

    jmodel, model = models("bro", BRO)
    states = jmodel.states
    model.restore_from_tree(_carried("bro", jmodel, states))
    assert_tree_close(model.checkpoint_tree(), _carried("bro", jmodel, states), 0.0, "carried")
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    close(model.act(torch.tensor(obs), noise=normals(key, (8, 1))), jmodel.act(states, obs, key, 0), 1e-6, "act")
    close(model.eval_act(torch.tensor(obs)), jmodel.eval_act(states, obs), 1e-6, "eval_act")
    buffer = _filled_buffer(jmodel, rng, 3, 1)
    assert model.first_reset_step == 1
    jupdate = jax.jit(jmodel.update_with_buffer)
    for step in (0, 1):
        key = jax.random.PRNGKey(30 + step)
        states, jmetrics = jupdate(states, buffer, key, step)
        loop_key, policy_key, policy_sample_key = jax.random.split(key, 3)
        batches, critic_draws = [], []
        for step_key in jax.random.split(loop_key, 2):
            sample_key, update_key = jax.random.split(step_key)
            batches.append(to_torch(np_tree(jrb.sample(buffer, sample_key, B))))
            critic_draws.append(normals(update_key, (B, 1)))
        batches.append(to_torch(np_tree(jrb.sample(buffer, policy_sample_key, B))))
        current_key, optimistic_key = jax.random.split(policy_key)
        batch_iter, draw_iter = iter(batches), iter(critic_draws)
        critic_update, policy_alpha_update = model.critic_update, model.policy_alpha_update
        model.sample_batch = lambda _: next(batch_iter)
        model.critic_update = lambda b: critic_update(b, target_noise=next(draw_iter))
        model.policy_alpha_update = lambda b: policy_alpha_update(
            b, current_noise=normals(current_key, (B, 1)), optimistic_noise=normals(optimistic_key, (B, 1)))
        metrics = model.update_with_buffer(None, step)
        del model.sample_batch, model.critic_update, model.policy_alpha_update
        assert set(metrics) == set(jmetrics)
        for k in jmetrics:
            close(float(metrics[k]), float(jmetrics[k]), 1e-5, f"step {step}: {k}")
        assert float(metrics["bro/reset"]) == step
        assert_tree_close(model.checkpoint_tree(), _carried("bro", jmodel, states), 1e-5, f"after step {step}")
    # the reset step: parameters back to init_copy; Adam and the target not
    for name in ("policy", "critic", "optimistic_policy"):
        for k, v in getattr(model, name).module.state_dict().items():
            assert torch.equal(v, model.init_copy[f"{name}.{k}"]), (name, k)
    assert not torch.equal(model.critic.target.head.weight, model.init_copy["critic.head.weight"])
    moments = adam_moments(model.critic.optimizer, model.critic.module)
    assert_tree_close(moments, convert.bro_critic_state_dict(jax_adam_mu(states["critic"].opt_state)), 1e-5,
                      "critic Adam moments")
    assert all(m.abs().sum() > 0 for m in moments.values())
    assert model.critic.step_count() == 4 and model.policy.step_count() == 2 and model.optimism.step_count() == 2


def test_soft_projection_matches_jax():
    """``MPO.soft_projection`` against the JAX package's expression in
    ``mpo.py::_critic_step``, with positions past either end of the support
    and on atoms."""
    import jax.numpy as jnp

    model = create_model(make_config("mpo.cuda", "classic.pendulum.cuda", **{
        "runner.device": "cpu", "algorithm.nr_atoms": 11, "algorithm.v_min": -10.0, "algorithm.v_max": 10.0,
        "algorithm.policy_hidden_sizes": (8,), "algorithm.critic_hidden_sizes": (8,)}))
    rng = np.random.default_rng(2)
    n, atoms = 64, np.linspace(-10.0, 10.0, 11).astype(np.float32)
    next_pmf = rng.dirichlet(np.ones(11), size=(2, n)).astype(np.float32)
    reward = (6.0 * rng.normal(size=n)).astype(np.float32)
    reward[:8] = 0.0                       # on the atoms
    reward[8:16] = 40.0                    # every position past v_max
    reward[16:24] = -40.0                  # below v_min
    terminated = (rng.random(n) < 0.2).astype(np.float32)
    discount = np.full(n, 0.99, np.float32)
    discount[:8] = 1.0
    terminated[:8] = 0.0
    target_z = jnp.clip(reward[:, None] + discount[:, None] * (1.0 - terminated)[:, None] * jnp.asarray(atoms)[None],
                        -10.0, 10.0)
    weights = jnp.clip(1.0 - jnp.abs(target_z[:, None, :] - jnp.asarray(atoms)[None, :, None]) / 2.0, 0.0, 1.0)
    ref = jnp.einsum("bts,nbs->nbt", weights, next_pmf)
    ours = model.soft_projection(*(torch.tensor(x) for x in (next_pmf, reward, terminated, discount)))
    close(ours, ref, 1e-6, "soft projection")
    close(ours.sum(-1), np.ones((2, n)), 1e-6, "mass")


def test_defaults_match_jax():
    """Every key and value of the JAX package's defaults, the mesh's
    ``shard_local_sampling`` included."""
    import importlib

    for algorithm in ("bro", "mpo", "fastmpo"):
        ref = importlib.import_module(f"rlx_tpu.algorithms.{algorithm}.tpu.default_config").get_config("x").to_dict()
        ref = {k: v for k, v in ref.items() if k != "name"}
        ours = dict(make_config(f"{algorithm}.cuda", "classic.pendulum.cuda").algorithm)
        assert ours.pop("name") == f"{algorithm}.cuda"
        assert ours == ref, algorithm
