"""Many-iteration parity of the port's transformer PPO against the JAX
package's, on the CPU, at the ``pendulum_masked_transformer`` recipe's
shape and hyperparameters (8 envs x 256 steps, 4 minibatches, 10 epochs,
lr 5e-4, gamma 0.9, the default transformer: context 16, 4 heads, 2
blocks), in float64 on both sides.

    python tests/torch_c2_transformer_parity.py --iterations 10 --control 1e-12 3e-8 --out c2.json

Both packages start from the same parameters (the JAX model's, converted)
and run ``--iterations`` whole learning iterations: the rollout on the
velocity-masked Pendulum, whose every reset puts each env back at the same
fixed state (so the two envs need no shared random stream), with JAX's
own action normals and env permutations replayed from its key chain into
the port.  Further JAX copies, each with its policy parameters scaled by
``1 + eps`` for an ``eps`` of ``--control``, run the same iterations: the
growth of a perturbation of that size through the same loop, the
yardstick for the port's gap.
After each iteration the script prints each net's largest parameter
difference relative to the net's largest parameter, port against JAX and
JAX against its perturbed copy, and the largest relative difference of the
iteration's metrics, and writes them to ``--out``.  First it runs one
forward of the critic in float64 on both sides, with the port's trunk
output as it is and rounded to float32: the JAX nets cast their trunk's
output to float32 before the head (``rlx_tpu/models/mlp.py``, the
``x.astype(jnp.float32)`` after the ``MLP``), also under x64, which sets
the floor of the float64 comparison.  A JAX-compiling script, so it is not
part of the test suite (no ``test_`` prefix).
"""

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from rlx_tpu.environments import wrappers as jax_wrappers  # noqa: E402
from rlx_tpu.environments.classic.pendulum.tpu.environment import Pendulum as JaxPendulum  # noqa: E402
from rlx_tpu.environments.classic.pendulum.tpu.environment import PendulumPhysics as JaxPhysics  # noqa: E402
from rlx_tpu_torch import convert  # noqa: E402
from rlx_tpu_torch.benchmarks.curves import RUNS  # noqa: E402
from rlx_tpu_torch.config import create_model, make_config  # noqa: E402
from rlx_tpu_torch.environments import wrappers  # noqa: E402
from rlx_tpu_torch.environments.classic.pendulum.cuda.environment import Pendulum, PendulumPhysics  # noqa: E402
from rlx_tpu_torch.environments.classic.pendulum.cuda.general_properties import GeneralProperties  # noqa: E402
from torch_parity import np_tree  # noqa: E402

jax.config.update("jax_platforms", "cpu")

RECIPE = "pendulum_masked_transformer"
E, T = 8, 256
THETA = np.random.default_rng(0).uniform(-np.pi, np.pi, E)
THETA_DOT = np.random.default_rng(1).uniform(-1.0, 1.0, E)


class FixedPendulum(Pendulum):
    def initial_physics(self, generator, eval_mode):
        return PendulumPhysics(torch.tensor(THETA), torch.tensor(THETA_DOT))


class FixedJaxPendulum(JaxPendulum):
    def initial_physics(self, key, eval_mode):
        return JaxPhysics(jnp.asarray(THETA), jnp.asarray(THETA_DOT))


def relative_gap(ours, ref):
    """Largest |ours - ref| over the net's tensors, over its largest |ref|."""
    gap = max(float(np.abs(np.asarray(ours[k], np.float64) - np.asarray(ref[k], np.float64)).max()) for k in ref)
    return gap / max(float(np.abs(np.asarray(v, np.float64)).max()) for v in ref.values())


def jax_draws(key, epochs, minibatches):
    noise = []
    for _ in range(T):
        key, action_key = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(action_key, (E, 1))))
    _, perm_key = jax.random.split(key)
    env_indices = jax.random.permutation(perm_key, jnp.tile(jnp.arange(E), (epochs, 1)), axis=1, independent=True)
    return (torch.tensor(np.stack(noise)),
            torch.tensor(np.asarray(env_indices).reshape(epochs * minibatches, E // minibatches)))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--iterations", type=int, default=10)
    parser.add_argument("--control", type=float, nargs="+", default=[1e-12, 3e-8])
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    torch.set_num_threads(1)
    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config

    overrides = {**RUNS[RECIPE]["overrides"], "algorithm.total_timesteps": args.iterations * E * T,
                 "algorithm.evaluation_active": False, "algorithm.logging_active": True}
    epochs, minibatches = overrides["algorithm.nr_epochs"], overrides["algorithm.nr_minibatches"]
    horizon = 200
    jenv = jax_wrappers.ObservationMaskWrapper(FixedJaxPendulum(E, horizon), [0, 1])
    jax_overrides = {k: v for k, v in overrides.items() if k != "environment.mask_velocity"}
    jmodel = jax_create_model(jax_make_config("ppo_transformer.tpu", "classic.pendulum.tpu", **jax_overrides,
                                              **{"runner.mesh_dp": 1}), jenv, jenv)
    env = wrappers.ObservationMaskWrapper(FixedPendulum(E, horizon, device="cpu"), [0, 1])
    env.general_properties = GeneralProperties
    port_overrides = {k: v for k, v in overrides.items() if k != "environment.mask_velocity"}
    model = create_model(make_config("ppo_transformer.cuda", "classic.pendulum.cuda", **port_overrides,
                                     **{"runner.device": "cpu"}), env, env)
    model.policy.load_state_dict(convert.recurrent_policy_state_dict(np_tree(jmodel.policy_state.params)))
    model.critic.load_state_dict(convert.critic_state_dict(np_tree(jmodel.critic_state.params)))
    model.policy.double()
    model.critic.double()

    # one critic forward: the port's trunk output as it is, and rounded to
    # float32 as the JAX critic rounds it
    obs = np.random.default_rng(2).normal(size=(64, 2))
    with jax.enable_x64(True):
        ref = np.asarray(jmodel.critic.apply(jax.tree.map(lambda a: a.astype(jnp.float64), jmodel.critic_state.params),
                                             jnp.asarray(obs))).reshape(-1)
    trunk_out = model.critic.trunk(torch.tensor(obs))
    forward = {}
    for label, features in (("as is", trunk_out), ("trunk output rounded to float32", trunk_out.float().double())):
        ours = model.critic.value(features).detach().numpy().reshape(-1)
        forward[label] = float(np.abs(ours - ref).max() / np.abs(ref).max())
    print("critic forward, largest gap relative to the largest value: " + json.dumps(forward), flush=True)

    logged = []
    jmodel._log_train_callback = lambda metrics, *_: logged.append({k: float(v) for k, v in metrics.items()})
    to64 = lambda tree: jax.tree.map(lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating)
                                     else a, tree)
    rows = []
    env_state, carry = env.reset(0), model.policy.initialize_carry(E)
    start = time.perf_counter()
    with jax.enable_x64(True):
        iteration = jax.jit(lambda c: jmodel._learning_iteration(c, 0, 0)[0])
        jcarry = (to64(jmodel.policy_state), to64(jmodel.critic_state), to64(jenv.reset(jax.random.PRNGKey(0))),
                  to64(jmodel.policy.initialize_carry(E)), jax.random.PRNGKey(5))
        controls = {eps: (jcarry[0].replace(params=jax.tree.map(lambda p, eps=eps: p * (1.0 + eps), jcarry[0].params)),
                          *jcarry[1:]) for eps in args.control}
        for it in range(args.iterations):
            noise, env_indices = jax_draws(jcarry[4], epochs, minibatches)
            jcarry = jax.block_until_ready(iteration(jcarry))
            jax.effects_barrier()
            jmetrics = logged[-1]
            for eps in controls:
                controls[eps] = jax.block_until_ready(iteration(controls[eps]))
            jax.effects_barrier()
            env_state, carry, metrics = model.learning_iteration(env_state, carry, noise, env_indices)
            ref_policy = convert.recurrent_policy_state_dict(np_tree(jcarry[0].params))
            ref_critic = convert.critic_state_dict(np_tree(jcarry[1].params))
            row = {
                "iteration": it + 1,
                "port_vs_jax": {"policy": relative_gap(model.policy.state_dict(), ref_policy),
                                "critic": relative_gap(model.critic.state_dict(), ref_critic)},
                **{f"jax_vs_jax_perturbed_by_{eps:g}": {
                    "policy": relative_gap(convert.recurrent_policy_state_dict(np_tree(c[0].params)), ref_policy),
                    "critic": relative_gap(convert.critic_state_dict(np_tree(c[1].params)), ref_critic)}
                   for eps, c in controls.items()},
                "metrics_max_relative_gap": max(abs(float(metrics[k]) - v) / max(abs(v), 1e-12)
                                                for k, v in jmetrics.items() if k in metrics),
                "episode_return": jmetrics.get("rollout/episode_return"),
                "seconds": time.perf_counter() - start,
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
    result = {"recipe": RECIPE, "overrides": {k: str(v) for k, v in overrides.items()},
              "critic_forward_relative_gap": forward, "control_eps": args.control, "iterations": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
