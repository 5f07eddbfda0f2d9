"""The port's ESPO and PPO-DTRL against the JAX package's:

- the trust-region functions (``gaussian_kl_parts``, ``mean_projection``,
  ``cov_projection``, ``kl_projection``, ``entropy_projection``): values
  and gradients against ``jax.grad`` in float64 on both sides (1e-9), on
  rows that need a projection, a row that needs none (equal old and new
  Gaussians: no NaN in either package's gradient), rows whose Newton
  iterate runs into the upper bound 12 of ``log_eta`` and rows that sit at
  the lower bound -10; the covariance projection also at 3 Newton steps,
  where rows stop short of their root and the gradient through each
  step's derivative shows.  In float32 the covariance KL minus its bound
  cancels, so ``eta`` lands on f32's rounding floor (9e-5 relative between
  the packages) while the projected std agrees at 3e-6;
- ``clip`` against ``jnp.clip`` at and beyond its bounds, gradients
  included (half the gradient at a tie, as ``jnp.clip``; ``torch.clamp``
  passes all of it);
- one PPO-DTRL ``_optimize`` from converted parameters with JAX's epoch
  permutations, at bounds small enough that every projection binds, with
  the entropy projection on, in float64 on both sides (1e-5);
- ESPO's ``_optimize`` with a ``max_ratio_delta`` that stops it after its
  second epoch, twice in a row (the second call's learning rate reads the
  optimizer step count), with the mean and the median operator:
  parameters, the Adam step counts, the learning rate and every metric
  (1e-5); ``median`` against ``jnp.median`` on even and odd counts;
- the defaults, and each algorithm through ``train()`` on Pendulum.
"""

import numpy as np
import pytest
import torch

from rlx_tpu_torch import convert
from rlx_tpu_torch.algorithms.espo.cuda.espo import median
from rlx_tpu_torch.algorithms.ppo_dtrl.cuda import trust_region as tr
from rlx_tpu_torch.config import create_model, make_config
from torch_parity import close, np_tree
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)


def _gaussians(rng, B=48, A=3):
    old_mean = rng.normal(size=(B, A))
    old_std = np.exp(rng.normal(scale=0.5, size=(B, A)))
    mean = old_mean + rng.normal(scale=0.3, size=(B, A))
    std = old_std * np.exp(rng.normal(scale=0.3, size=(B, A)))
    mean[0], std[0] = old_mean[0], old_std[0]                 # needs no projection
    std[1:4] = old_std[1:4] * 1e-4                           # log_eta runs into 12
    # a covariance KL just past the bound 1e-3: log_eta runs into -10
    for row, excess, sign in ((4, 1e-6, 1.0), (5, 1e-7, 1.0), (6, 3e-6, 1.0)):
        std[row] = old_std[row] * np.exp(sign * _log_ratio_at(0.001 * (1.0 + excess), A))
    std[7] = old_std[7] * 50.0
    return mean, std, old_mean, old_std


def _log_ratio_at(cov_part, A):
    """|d| with cov-KL ``0.5 A (2 d + exp(-2 d) - 1)`` equal to ``cov_part``
    (bisection; ``d > 0``)."""
    lo, hi = 0.0, 1.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if 0.5 * A * (2.0 * mid + np.exp(-2.0 * mid) - 1.0) < cov_part else (lo, mid)
    return hi


def test_trust_region_matches_jax_in_float64():
    import jax
    import jax.numpy as jnp

    from rlx_tpu.algorithms.ppo_dtrl.tpu import trust_region as jtr

    rng = np.random.default_rng(0)
    mean, std, old_mean, old_std = _gaussians(rng)
    w = rng.normal(size=(4,) + mean.shape)

    def jax_loss(mean, std):
        p = jtr.kl_projection(mean, std, old_mean, old_std, 0.03, 0.001)
        log_std = jtr.entropy_projection(jnp.log(p["std"]), 1.5)
        total = (p["mean"] * w[0]).sum() + (p["std"] * w[1]).sum() + (log_std * w[2]).sum()
        total += 1e-3 * p["eta_cov"].sum() + sum(p[k].sum() for k in p if k.endswith("part"))
        return total, p

    def ours_loss(mean, std):
        p = tr.kl_projection(mean, std, *map(torch.tensor, (old_mean, old_std)), 0.03, 0.001)
        log_std = tr.entropy_projection(torch.log(p["std"]), 1.5)
        total = (p["mean"] * torch.tensor(w[0])).sum() + (p["std"] * torch.tensor(w[1])).sum()
        total = total + (log_std * torch.tensor(w[2])).sum()
        total = total + 1e-3 * p["eta_cov"].sum() + sum(p[k].sum() for k in p if k.endswith("part"))
        return total, p

    with jax.enable_x64(True):
        (_, ref), ref_grads = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(mean),
                                                                                          jnp.asarray(std))
        eta = np.asarray(ref["eta_cov"])
        ref = np_tree(ref)
    inputs = [torch.tensor(x, requires_grad=True) for x in (mean, std)]
    total, ours = ours_loss(*inputs)
    grads = torch.autograd.grad(total, inputs)
    for k in ref:
        close(ours[k], ref[k], 1e-9, k)
    for name, g, r in zip(("mean", "std"), grads, ref_grads):
        assert torch.isfinite(g).all(), name
        close(g, r, 1e-9, f"gradient wrt {name}")
    # the cases the rows were made for
    assert eta[0] == 0.0 and np.allclose(np.log(eta[1:4]), 12.0) and np.allclose(np.log(eta[4:7]), -10.0)
    assert (eta[7:] > 0).all()
    # each function on its own
    with jax.enable_x64(True):
        m, s, om, os_ = (jnp.asarray(x) for x in (mean, std, old_mean, old_std))
        ref_parts = jtr.gaussian_kl_parts(m, s, om, os_)
        ref_mean = jtr.mean_projection(m, om, os_, 0.03)
        ref_cov = jtr.cov_projection(s, os_, 0.001)
        ref_entropy = jtr.entropy_projection(jnp.log(s), -1.0)
    t = [torch.tensor(x) for x in (mean, std, old_mean, old_std)]
    for ours_out, ref_out, what in ((tr.gaussian_kl_parts(*t), ref_parts, "kl parts"),
                                    (tr.mean_projection(t[0], t[2], t[3], 0.03), ref_mean, "mean projection"),
                                    (tr.cov_projection(t[1], t[3], 0.001), ref_cov, "cov projection")):
        for o, r in zip(ours_out, ref_out):
            close(o, np.asarray(r), 1e-9, what)
    # 3 Newton steps leave rows short of their root, where the gradient
    # also flows through the derivative inside each step (at a root its
    # term is multiplied by a zero KL excess)
    with jax.enable_x64(True):
        (ref_std, ref_eta), vjp = jax.vjp(lambda s_: jtr.cov_projection(s_, os_, 0.001, 3), s)
        (ref_grad,) = vjp((jnp.asarray(w[3]), jnp.asarray(w[3][:, 0])))
    std_in = torch.tensor(std, requires_grad=True)
    proj_std, proj_eta = tr.cov_projection(std_in, t[3], 0.001, 3)
    (grad,) = torch.autograd.grad((proj_std * torch.tensor(w[3])).sum() + (proj_eta * torch.tensor(w[3][:, 0])).sum(),
                                  std_in)
    close(proj_std, np.asarray(ref_std), 1e-9, "cov projection, 3 steps")
    close(proj_eta, np.asarray(ref_eta), 1e-9, "eta, 3 steps")
    close(grad, np.asarray(ref_grad), 1e-9, "cov projection gradient, 3 steps")
    # the JAX module computes its log(2 pi e) constant in float32 at import
    close(tr.entropy_projection(torch.log(t[1]), -1.0), np.asarray(ref_entropy), 1e-7, "entropy projection")


def test_clip_passes_gradients_as_jnp_clip():
    import jax
    import jax.numpy as jnp

    x = np.array([-12.0, -10.0, -3.0, 0.0, 2.0, 12.0, 15.0], np.float32)
    ref, ref_grad = jax.value_and_grad(lambda v: (jnp.clip(v, -10.0, 12.0) * jnp.arange(1.0, 8.0)).sum())(x)
    v = torch.tensor(x, requires_grad=True)
    out = (tr.clip(v, -10.0, 12.0) * torch.arange(1.0, 8.0)).sum()
    (grad,) = torch.autograd.grad(out, v)
    close(out, ref, 0.0, "value")
    close(grad, ref_grad, 0.0, "gradient")
    assert grad.tolist() == [0.0, 1.0, 3.0, 4.0, 5.0, 3.0, 0.0]


SHARED = {"environment.nr_envs": 4, "algorithm.nr_steps": 8, "algorithm.policy_hidden_sizes": (16, 16),
          "algorithm.critic_hidden_sizes": (16, 16), "algorithm.activation": "elu", "algorithm.layer_norm": True,
          "algorithm.logging_active": False, "algorithm.evaluation_active": False}
N = 32


def _models(algorithm, overrides):
    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config

    shared = {**SHARED, **overrides}
    jmodel = jax_create_model(jax_make_config(f"{algorithm}.tpu", "locomotion.ant.tpu", **shared,
                                              **{"runner.mesh_dp": 1}))
    model = create_model(make_config(f"{algorithm}.cuda", "locomotion.ant.cuda", **shared, **{"runner.device": "cpu"}))
    model.policy.module.load_state_dict(convert.policy_state_dict(np_tree(jmodel.policy_state.params)))
    model.critic.load_state_dict(convert.critic_state_dict(np_tree(jmodel.critic_state.params)))
    return jmodel, model


def _batch(rng):
    return (rng.normal(size=(N, 34)).astype(np.float32), rng.normal(size=(N, 8)).astype(np.float32),
            rng.normal(size=N).astype(np.float32) - 8.0, rng.normal(size=N).astype(np.float32),
            rng.normal(size=N).astype(np.float32))


def _assert_nets(model, policy_state, critic_state, tol, what):
    for name, ref in convert.policy_state_dict(np_tree(policy_state.params)).items():
        got = model.policy.module.state_dict()[name]
        torch.testing.assert_close(got, ref.to(got.dtype), rtol=tol, atol=tol,
                                   msg=lambda m: f"{what} policy {name}: {m}")
    for name, ref in convert.critic_state_dict(np_tree(critic_state.params)).items():
        got = model.critic.state_dict()[name]
        torch.testing.assert_close(got, ref.to(got.dtype), rtol=tol, atol=tol,
                                   msg=lambda m: f"{what} critic {name}: {m}")


def test_ppo_dtrl_optimize_matches_jax():
    """Tiny bounds bind the mean and the covariance projection from the
    second minibatch on; the minimum entropy binds the entropy projection.
    In float64 on both sides: in float32 the covariance KL minus its bound
    cancels and ``projection/eta_cov`` lands on f32's rounding floor (0.6 %
    apart between the packages at a bound of 1e-5)."""
    import jax
    import jax.numpy as jnp

    jmodel, model = _models("ppo_dtrl", {"algorithm.minibatch_size": 8, "algorithm.nr_epochs": 2,
                                         "algorithm.total_timesteps": 2 * N, "algorithm.learning_rate": 3e-3,
                                         "algorithm.mean_bound": 1e-4, "algorithm.cov_bound": 1e-5,
                                         "algorithm.entropy_projection_active": True, "algorithm.min_entropy": 11.6})
    batch = tuple(x.astype(np.float64) for x in _batch(np.random.default_rng(1)))
    key = jax.random.PRNGKey(3)
    _, perm_key = jax.random.split(key)
    epoch_indices = jax.random.permutation(perm_key, np.tile(np.arange(N), (2, 1)), axis=1, independent=True)
    model.policy.module.double()
    model.critic.double()
    with jax.enable_x64(True):
        to64 = lambda tree: jax.tree.map(lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating)
                                         else a, tree)
        policy_state, critic_state, jmetrics = jax.jit(jmodel._optimize)(
            to64(jmodel.policy_state), to64(jmodel.critic_state), batch, key)
        jmetrics = {k: float(v) for k, v in jmetrics.items()}
        metrics = model._optimize(tuple(torch.tensor(x) for x in batch),
                                  epoch_indices=torch.tensor(np.asarray(epoch_indices)))
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        close(float(metrics[k]), jmetrics[k], 1e-5, k)
    assert jmetrics["projection/eta_cov"] > 0.0
    assert jmetrics["projection/unprojected_kl_mean"] > jmetrics["projection/projected_kl_mean"]
    _assert_nets(model, policy_state, critic_state, 1e-5, "after")
    assert model.nr_optimizer_steps == 8 and model.old_policy is None


@pytest.mark.parametrize("operator", ["mean", "median"])
def test_espo_early_stop_matches_jax(operator):
    """``max_ratio_delta`` 1e-3 lets epochs 0 and 1 step (epoch 0's ratio
    is exactly 1) and stops epochs 2-5; a port that stepped Adam, or only
    counted a step, on a stopped epoch would differ in its parameters, its
    Adam counts or its second call's learning rate."""
    import jax

    jmodel, model = _models("espo", {"algorithm.minibatch_size": N, "algorithm.nr_epochs": 6,
                                     "algorithm.total_timesteps": 4 * N, "algorithm.max_ratio_delta": 1e-3,
                                     "algorithm.delta_calc_operator": operator, "algorithm.learning_rate": 1e-2})
    policy_state, critic_state = jmodel.policy_state, jmodel.critic_state
    joptimize = jax.jit(jmodel._optimize)
    rng = np.random.default_rng(2)
    for call in (0, 1):
        batch = list(_batch(rng))
        # the policy's own log-probabilities: the first epoch's ratio is 1
        batch[2] = model.policy.log_prob_entropy(torch.tensor(batch[0]), torch.tensor(batch[1]))[0].detach().numpy()
        batch = tuple(batch)
        policy_state, critic_state, jmetrics = joptimize(policy_state, critic_state, batch, jax.random.PRNGKey(call))
        metrics = model._optimize(tuple(torch.tensor(x) for x in batch))
        assert set(metrics) == set(jmetrics)
        for k in jmetrics:
            close(float(metrics[k]), float(jmetrics[k]), 1e-5, f"call {call}: {k}")
        assert float(metrics["policy_ratio/nr_active_epochs"]) == 2.0
        _assert_nets(model, policy_state, critic_state, 1e-5, f"call {call}")
        count = int(policy_state.opt_state[1].count)
        assert model.nr_optimizer_steps == count == 2 * (call + 1)
        assert model.policy_optimizer.state[model.policy.module.policy_logstd]["step"] == count
    # the schedule's period is nr_minibatches * nr_epochs = 6 steps: after 4
    # steps the second call's rate is the base rate (6 counted steps would have annealed it)
    close(float(metrics["lr/learning_rate"]), 1e-2, 1e-7, "second call's learning rate")


def test_median_is_jnp_median():
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    for n in (1, 2, 7, 64):
        x = rng.random(n).astype(np.float32)
        assert float(median(torch.tensor(x))) == float(jnp.median(x)), n
    x = torch.tensor([1.0, 2.0, 3.0, 10.0])
    assert float(median(x)) == 2.5 and float(torch.median(x)) == 2.0


def test_defaults_match_jax():
    """Every key and value of the JAX package's defaults."""
    import importlib

    for algorithm in ("espo", "ppo_dtrl"):
        ref = importlib.import_module(f"rlx_tpu.algorithms.{algorithm}.tpu.default_config").get_config("x").to_dict()
        ref = {k: v for k, v in ref.items() if k != "name"}
        ours = dict(make_config(f"{algorithm}.cuda", "classic.pendulum.cuda").algorithm)
        assert ours.pop("name") == f"{algorithm}.cuda"
        assert ours == ref, algorithm


@pytest.mark.parametrize("algorithm", ["espo", "ppo_dtrl"])
def test_trains_on_pendulum(algorithm):
    model = create_model(make_config(f"{algorithm}.cuda", "classic.pendulum.cuda", **{
        "runner.device": "cpu", "environment.nr_envs": 4, "algorithm.nr_steps": 8, "algorithm.minibatch_size": 16,
        "algorithm.nr_epochs": 2, "algorithm.total_timesteps": 64, "environment.horizon": 16,
        "algorithm.policy_hidden_sizes": (16, 16), "algorithm.critic_hidden_sizes": (16, 16)}))
    model.train()
    assert len(model.metrics_history) == 2 and len(model.eval_history["eval/episode_return"]) == 1
    assert all(np.isfinite(v) for m in model.metrics_history for v in m.values())
