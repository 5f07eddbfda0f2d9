"""Long-horizon parity of the port's FlashSAC and SimbaV2 against the JAX
package's, on the CPU, at the Pendulum learning recipes' configurations
(``pendulum_spot_flashsac`` / ``pendulum_spot_simbav2``: gamma 0.9, a
[-300, 0] support, the normalizers off, the default widths).

    python tests/torch_long_horizon_parity.py --updates 300 --out drift.json

Both packages start from the same parameters (the JAX model's, converted)
and take ``--updates`` updates on the same batches: uniform draws, with
numpy indices, from one table of Pendulum transitions that the port's env
collects under uniform random actions, with JAX's normals handed to the
port's update.  Each algorithm runs twice: in float64 on both sides, where
a fault in the port shows as a gap that grows far past rounding, and in
float32 on both sides, where rounding alone is amplified by the training
loop.  ``--control EPS`` runs JAX against itself instead, one copy's
critic parameters scaled by ``1 + EPS``: the growth of a perturbation of
that size through the same updates, the yardstick for the port's gap.
After the updates named by ``--report`` the script prints each
net's largest parameter difference relative to the largest parameter
(policy, critic, the critic's target, log alpha) and every metric's
largest relative difference so far, and writes them to ``--out``.  A
JAX-compiling script, so it is not part of the test suite; it takes a few
minutes a run on one CPU thread.
"""

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from rlx_tpu.models import distributions as jax_distributions  # noqa: E402
from rlx_tpu_torch import convert  # noqa: E402
from rlx_tpu_torch.benchmarks.curves import RUNS  # noqa: E402
from torch_parity import models, normals, np_tree, to_torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "float32")

ALGORITHMS = ("flashsac", "simbav2")
LOG_2PI_F32 = jax_distributions.LOG_2PI


class _Float64Numpy:
    """numpy with ``float32`` standing for ``float64``: the converters in
    ``rlx_tpu_torch.convert`` cast to float32, which would round the
    float64 run's JAX parameters before they are compared."""

    def __getattr__(self, name):
        return np.float64 if name == "float32" else getattr(np, name)


def jax_trees(algorithm, states):
    """The JAX states as the port's state dicts, by net (in the states'
    precision)."""
    saved = convert.np
    convert.np = _Float64Numpy()
    try:
        return _jax_trees(algorithm, states)
    finally:
        convert.np = saved


def _jax_trees(algorithm, states):
    p, c = states["policy"], states["critic"]
    if algorithm == "flashsac":
        trees = {
            "policy": convert.flashsac_policy_state_dict(np_tree(p.params), np_tree(p.batch_stats)),
            "critic": convert.flashsac_critic_state_dict(np_tree(c.params), np_tree(c.batch_stats)),
            "critic_target": convert.flashsac_critic_state_dict(np_tree(c.target_params),
                                                                np_tree(c.target_batch_stats)),
        }
    else:
        trees = {
            "policy": convert.simbav2_policy_state_dict(np_tree(p.params)),
            "critic": convert.simbav2_critic_state_dict(np_tree(c.params)),
            "critic_target": convert.simbav2_critic_state_dict(np_tree(c.target_params)),
        }
    trees["alpha"] = convert.entropy_coefficient_state_dict(np_tree(states["alpha"].params))
    return trees


def port_trees(model):
    return {"policy": model.policy.module.state_dict(), "critic": model.critic.module.state_dict(),
            "critic_target": model.critic.target.state_dict(), "alpha": model.alpha.module.state_dict()}


def relative_gap(ours, ref):
    """max |ours - ref| over a net's tensors, over max |ref|."""
    gap = max(float((ours[k].double() - ref[k].double()).abs().max()) for k in ref)
    scale = max(float(ref[k].double().abs().max()) for k in ref)
    return gap / scale


def align_supports(model):
    """Give the port the JAX package's f32 categorical supports: ``jnp.linspace``
    and ``torch.linspace`` round some atoms differently in the last bit
    (up to 1.5e-5 over [-300, 0] with 101 atoms), which would otherwise
    stand in the float64 run for a difference of the updates.  Returns the
    largest change."""
    changed = 0.0

    def jax_support(t):
        ref = np.asarray(jnp.linspace(float(t[0]), float(t[-1]), len(t), dtype=jnp.float32))
        return torch.as_tensor(ref, dtype=t.dtype)

    modules = [m for m in vars(model).values() if isinstance(m, torch.nn.Module)]
    modules += [m for state in vars(model).values() for m in (getattr(state, "module", None),
                getattr(state, "target", None)) if isinstance(m, torch.nn.Module)]
    for module in modules:
        for sub in module.modules():
            if isinstance(getattr(sub, "bins", None), torch.Tensor):
                changed = max(changed, float((sub.bins - jax_support(sub.bins)).abs().max()))
                sub.bins = jax_support(sub.bins)
    if isinstance(getattr(model, "bins", None), torch.Tensor):
        changed = max(changed, float((model.bins - jax_support(model.bins)).abs().max()))
        model.bins = jax_support(model.bins)
    return changed


def pendulum_transitions(model, steps, seed):
    """``steps`` env steps of the port's Pendulum (its 8 envs) under uniform
    actions in [-1, 1], as replay rows (the action before rescaling)."""
    env = model.train_env
    generator = torch.Generator().manual_seed(seed)
    state = env.reset(seed)
    rows = {k: [] for k in ("observation", "action", "next_observation", "reward", "terminated", "truncated")}
    for _ in range(steps):
        action = 2.0 * torch.rand(env.nr_envs, model.action_dim, generator=generator) - 1.0
        observation = state.observation
        state = env.step(state, model.process_action(action))
        for k, v in (("observation", observation), ("action", action), ("next_observation", state.final_observation),
                     ("reward", state.reward), ("terminated", state.terminated), ("truncated", state.truncated)):
            rows[k].append(v.float().numpy())
    return {k: np.concatenate(v) for k, v in rows.items()}


def run(algorithm, dtype, updates, report, seed=0, control=0.0):
    spec = RUNS[f"pendulum_spot_{algorithm}"]
    overrides = {**spec["overrides"], "algorithm.total_timesteps": spec["budget"],
                 "algorithm.evaluation_active": False}
    jmodel, model = models(algorithm, overrides)
    states = dict(jmodel.states)
    model.restore_from_tree(convert.checkpoint_tree_from_jax(algorithm, np_tree(jmodel.checkpoint_tree(states))))
    table = pendulum_transitions(model, 600, seed)
    support_change = align_supports(model)
    print(json.dumps({"algorithm": algorithm, "support_set_to_jax_changed_by": support_change}), flush=True)
    with jax.enable_x64(dtype == "float64"):
        try:
            return _updates(algorithm, dtype, jmodel, model, states, table, updates, report, seed, control)
        finally:
            jax_distributions.LOG_2PI = LOG_2PI_F32


def _updates(algorithm, dtype, jmodel, model, states, table, updates, report, seed, control):
    """The update loop; the models were built (and the JAX parameters
    carried across) in float32, so both sides start from the same values.
    With ``control`` the port's place is taken by a second JAX run whose
    critic parameters start ``control`` apart (relative): how far the
    training loop alone carries a perturbation of that size."""
    B, A = model.batch_size, model.action_dim
    if dtype == "float64":
        # the JAX package's log(2 pi) is a float32 constant made at import,
        # which would put float32 rounding into every float64 log-prob
        jax_distributions.LOG_2PI = np.float64(np.log(2.0 * np.pi))
        states = jax.tree.map(lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a,
                              states)
        for module in (model.policy.module, model.critic.module, model.critic.target, model.alpha.module):
            module.double()
    jupdate = jax.jit(jmodel.update)
    if control:
        critic = states["critic"]
        other = dict(states, critic=critic.replace(params=jax.tree.map(lambda a: a * (1.0 + control), critic.params)))
    rng = np.random.default_rng(seed)
    metric_gaps, rows = {}, []
    start = time.time()
    for step in range(updates):
        idx = rng.integers(0, len(table["reward"]), B)
        data = {k: v[idx].astype(dtype) for k, v in table.items()}
        key = jax.random.PRNGKey(1000 + step)
        states, jmetrics = jupdate(states, data, key, step)
        first_key, second_key = jax.random.split(key)
        noise = ({"policy_noise": normals(first_key, (B, A)), "target_noise": normals(second_key, (B, A))}
                 if algorithm == "flashsac" else
                 {"target_noise": normals(first_key, (B, A)), "current_noise": normals(second_key, (B, A))})
        if control:
            other, metrics = jupdate(other, data, key, step)
        else:
            metrics = model.update(to_torch(data), step, **noise)
        for k in jmetrics:
            ref = float(jmetrics[k])
            gap = abs(float(metrics[k]) - ref) / max(abs(ref), 1e-8)
            metric_gaps[k] = max(metric_gaps.get(k, 0.0), gap)
        if step + 1 in report:
            refs = jax_trees(algorithm, states)
            ours = jax_trees(algorithm, other) if control else port_trees(model)
            row = {"updates": step + 1, **{net: relative_gap(ours[net], refs[net]) for net in refs},
                   "worst_metric": max(metric_gaps.values()),
                   "worst_metric_name": max(metric_gaps, key=metric_gaps.get)}
            rows.append(row)
            print(json.dumps({"algorithm": algorithm, "dtype": dtype, "control": control, **row}), flush=True)
    return {"algorithm": algorithm, "dtype": dtype, "control": control, "batch": B, "rows": rows,
            "metric_gaps": metric_gaps,
            "seconds": time.time() - start}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--algorithms", nargs="+", choices=ALGORITHMS, default=list(ALGORITHMS))
    parser.add_argument("--dtypes", nargs="+", choices=("float64", "float32"), default=["float64", "float32"])
    parser.add_argument("--updates", type=int, default=300)
    parser.add_argument("--report", type=int, nargs="+", default=[1, 10, 30, 100, 200, 300])
    parser.add_argument("--seed", type=int, default=0, help="the transitions' and the batches' seed")
    parser.add_argument("--control", type=float, default=0.0,
                        help="compare JAX with JAX, the critic's parameters perturbed by this much (relative)")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    torch.set_num_threads(1)
    results = []
    for algorithm in args.algorithms:
        for dtype in args.dtypes:
            results.append(run(algorithm, dtype, args.updates, set(args.report), args.seed, args.control))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
