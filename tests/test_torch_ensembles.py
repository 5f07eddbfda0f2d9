"""The port's ensemble critics (REDQ, DroQ, AQE) and TQC against the JAX
package's:

- ``update_with_buffer`` over two env steps at a few critic updates each,
  from converted parameters: the port's loop is fed the batches JAX samples
  from the same buffer contents, JAX's normals, REDQ's subsets recomputed
  from the JAX keys as ``redq.py`` draws them, and DroQ's dropout masks,
  which a ``flax.linen.intercept_methods`` interceptor around
  ``nn.Dropout.__call__`` injects on the JAX side; every averaged metric,
  parameter, target and ``log_alpha`` after each step (1e-5);
- TQC's ``update`` over two steps and ``quantile_huber_loss``;
- each algorithm through ``train()`` on Pendulum, where the core calls
  ``update_with_buffer`` in place of sample + ``update``.
"""

import numpy as np
import pytest
import torch

from rlx_tpu_torch import convert
from rlx_tpu_torch.config import create_model, make_config
from torch_parity import assert_state_dict, batch, close, models, normals, np_tree, to_torch
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

B, Q_STEPS, HIDDEN = 16, 3, (16, 8)
SMALL = {
    "environment.nr_envs": 8,
    "algorithm.batch_size": B,
    "algorithm.policy_hidden_sizes": HIDDEN,
    "algorithm.critic_hidden_sizes": HIDDEN,
    "algorithm.evaluation_active": False,
}
ENSEMBLES = {
    "redq": {"algorithm.q_update_steps": Q_STEPS},
    "droq": {"algorithm.q_update_steps": Q_STEPS, "algorithm.dropout_rate": 0.2},
    "aqe": {"algorithm.q_update_steps": Q_STEPS},
}


def _load(model, states):
    model.policy.module.load_state_dict(convert.squashed_gaussian_policy_state_dict(np_tree(states["policy"].params)))
    model.critic.module.load_state_dict(convert.vector_q_critic_state_dict(np_tree(states["critic"].params)))
    model.critic.target.load_state_dict(convert.vector_q_critic_state_dict(np_tree(states["critic"].target_params)))
    model.alpha.module.load_state_dict(convert.entropy_coefficient_state_dict(np_tree(states["alpha"].params)))


def _assert_states(model, states, tol, when):
    assert_state_dict(model.policy.module, convert.squashed_gaussian_policy_state_dict(np_tree(states["policy"].params)),
                      tol, f"{when}: policy")
    for module, field in ((model.critic.module, "params"), (model.critic.target, "target_params")):
        assert_state_dict(module, convert.vector_q_critic_state_dict(np_tree(getattr(states["critic"], field))),
                          tol, f"{when}: critic {field}")
    assert_state_dict(model.alpha.module, convert.entropy_coefficient_state_dict(np_tree(states["alpha"].params)),
                      tol, f"{when}: log_alpha")


def _filled_buffer(jmodel, rng, rows=12):
    import jax.numpy as jnp

    from rlx_tpu.ops import replay_buffer as jrb

    buffer = jmodel._make_buffer()
    for _ in range(rows):
        step = batch(rng, 8, 3, 1)
        step["terminated"] = step["terminated"]
        buffer = jrb.add(buffer, {k: jnp.asarray(v) for k, v in step.items()})
    return buffer


class _DropoutMasks:
    """Replaces flax's ``nn.Dropout`` with seeded keep-masks, one per call
    in the order the JAX update traces them (target, online and policy
    forwards, two hidden layers each); each mask is shared by the critics
    of the ensemble and by the iterations of the critic loop."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.masks = []

    def __call__(self, next_fun, args, kwargs, context):
        import flax.linen as nn
        import jax.numpy as jnp

        if not (isinstance(context.module, nn.Dropout) and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        x = args[0]
        mask = self.rng.random(x.shape) >= context.module.rate
        self.masks.append(mask)
        return jnp.where(mask, x / (1.0 - context.module.rate), 0.0)

    def port(self, index, nr_critics):
        return [torch.tensor(m).expand(nr_critics, *m.shape) for m in self.masks[index:index + 2]]


@pytest.mark.parametrize("algorithm", sorted(ENSEMBLES))
def test_update_with_buffer_matches_jax(algorithm):
    import flax.linen as nn
    import jax

    from rlx_tpu.ops import replay_buffer as jrb

    jmodel, model = models(algorithm, {**SMALL, **ENSEMBLES[algorithm]})
    states = jmodel.states
    _load(model, states)
    rng = np.random.default_rng(len(algorithm))
    buffer = _filled_buffer(jmodel, rng)
    nr_critics = model.config.algorithm.nr_critics
    for step in (0, 1):
        key = jax.random.PRNGKey(40 + step)
        interceptor = _DropoutMasks(step)
        with nn.intercept_methods(interceptor):
            states, jmetrics = jmodel.update_with_buffer(states, buffer, key, step)
        # the JAX loop's draws, recomputed from its keys
        loop_key, policy_key, policy_sample_key = jax.random.split(key, 3)
        batches, critic_draws = [], []
        for step_key in jax.random.split(loop_key, Q_STEPS):
            sample_key, update_key = jax.random.split(step_key)
            batches.append(to_torch(np_tree(jrb.sample(buffer, sample_key, B))))
            target_key, subset_key, _, _ = jax.random.split(update_key, 4)
            draws = {"target_noise": normals(target_key, (B, 1))}
            if algorithm == "redq":
                draws["subset"] = torch.tensor(np.asarray(jax.random.choice(subset_key, nr_critics, (2,), replace=False)))
            if algorithm == "droq":
                assert len(interceptor.masks) == 6
                draws["target_masks"], draws["masks"] = interceptor.port(0, nr_critics), interceptor.port(2, nr_critics)
            critic_draws.append(draws)
        batches.append(to_torch(np_tree(jrb.sample(buffer, policy_sample_key, B))))
        policy_draws = {"current_noise": normals(jax.random.split(policy_key)[0], (B, 1))}
        if algorithm == "droq":
            policy_draws["masks"] = interceptor.port(4, nr_critics)
        batch_iter, draw_iter = iter(batches), iter(critic_draws)
        critic_update, policy_alpha_update = model.critic_update, model.policy_alpha_update
        model.sample_batch = lambda _: next(batch_iter)
        model.critic_update = lambda b: critic_update(b, **next(draw_iter))
        model.policy_alpha_update = lambda b: policy_alpha_update(b, **policy_draws)
        metrics = model.update_with_buffer(None, step)
        del model.sample_batch, model.critic_update, model.policy_alpha_update
        assert set(metrics) == set(jmetrics)
        for k in jmetrics:
            close(float(metrics[k]), float(jmetrics[k]), 1e-5, f"{algorithm} step {step}: {k}")
        _assert_states(model, states, 1e-5, f"{algorithm} after step {step}")
    assert model.critic.step_count() == 2 * Q_STEPS and model.policy.step_count() == 2


def test_tqc_two_updates_match_jax():
    import jax

    jmodel, model = models("tqc", {**SMALL, "algorithm.nr_atoms_per_net": 7, "algorithm.nr_dropped_atoms_per_net": 2},
                           "locomotion.ant")
    states = jmodel.states
    _load(model, states)
    rng = np.random.default_rng(9)
    jupdate = jax.jit(jmodel.update)
    for step in (0, 1):
        data = batch(rng, B, 34, 8, scale=2.0)
        key = jax.random.PRNGKey(50 + step)
        states, jmetrics = jupdate(states, data, key, step)
        target_key, current_key = jax.random.split(key)
        metrics = model.update(to_torch(data), step, target_noise=normals(target_key, (B, 8)),
                               current_noise=normals(current_key, (B, 8)))
        assert set(metrics) == set(jmetrics)
        for k in jmetrics:
            close(float(metrics[k]), float(jmetrics[k]), 1e-5, f"step {step}: {k}")
        _assert_states(model, states, 1e-5, f"after step {step}")


def test_quantile_huber_loss_matches_jax():
    import jax.numpy as jnp

    from rlx_tpu.algorithms.tqc.tpu.tqc import quantile_huber_loss as jax_loss
    from rlx_tpu_torch.algorithms.tqc.cuda.tqc import quantile_huber_loss

    rng = np.random.default_rng(4)
    pred = (2.0 * rng.normal(size=(2, 32, 5))).astype(np.float32)
    target = (2.0 * rng.normal(size=(32, 8))).astype(np.float32)
    taus = ((2.0 * np.arange(5) + 1.0) / 10.0).astype(np.float32)
    for kappa in (1.0, 0.5):
        ours = quantile_huber_loss(torch.tensor(pred), torch.tensor(target), torch.tensor(taus), kappa)
        close(ours, jax_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(taus), kappa), 1e-6, f"kappa {kappa}")


@pytest.mark.parametrize("algorithm", ["redq", "droq", "aqe", "tqc"])
def test_trains_on_pendulum(algorithm):
    """The core's learning step calls ``update_with_buffer`` for the
    ensembles: ``q_update_steps`` critic steps and one policy step an env
    step."""
    overrides = {**SMALL, "algorithm.total_timesteps": 192, "algorithm.learning_starts": 128,
                 "algorithm.buffer_size": 2048, "algorithm.logging_frequency": 32, "runner.device": "cpu"}
    if algorithm != "tqc":
        overrides["algorithm.q_update_steps"] = Q_STEPS
    model = create_model(make_config(f"{algorithm}.cuda", "classic.pendulum.cuda", **overrides))
    model.train()
    assert [m["steps/nr_updates"] for m in model.metrics_history] == [4, 8]
    assert all(np.isfinite(v) for m in model.metrics_history for v in m.values())
    assert model.policy.step_count() == 8
    assert model.critic.step_count() == 8 * (1 if algorithm == "tqc" else Q_STEPS)

