"""The port's CartPole (classic.cart_pole.cuda on CPU tensors) against the
JAX CartPole from the same initial states and the same actions, with
trajectories that cross the termination boundary: carts and poles pushed
over |x| = 2.4 and |theta| = 12 degrees, two envs resting exactly on the
boundary (strictly greater terminates), and a short horizon for the
truncations.  Both sides return the same fixed state at every reset (their
random streams differ), so every step is compared, auto-resets included.
f32 on both sides; the Euler steps round alike, but 40 steps let the last
bits drift: rtol=atol=1e-5, and the done flags exactly."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rlx_tpu.environments.classic.cart_pole.tpu.environment import CartPole as JaxCartPole
from rlx_tpu.environments.classic.cart_pole.tpu.environment import CartPolePhysics as JaxPhysics
from rlx_tpu_torch.config import create_env, make_config
from rlx_tpu_torch.environments.classic.cart_pole.cuda.environment import CartPole, CartPolePhysics
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

HORIZON, STEPS = 25, 40
TOL = 1e-5
THETA_LIMIT = np.float32(12.0 * 2.0 * math.pi / 360.0)
# x, x_dot, theta, theta_dot per env: near and on the boundaries
INITIAL = np.array([
    [2.30, 1.0, 0.0, 0.0],            # cart leaves through +2.4
    [-2.35, -0.8, 0.01, 0.0],         # cart leaves through -2.4
    [0.0, 0.0, 0.19, 0.6],            # pole falls past +12 degrees
    [0.1, 0.2, -0.2, -0.3],           # pole falls past -12 degrees
    [2.4, 0.0, 0.0, 0.0],             # on |x| = 2.4, at rest: not terminated at first
    [0.0, 0.0, THETA_LIMIT, 0.0],     # on |theta| = 12 degrees: not terminated at first
    [0.02, -0.01, 0.03, 0.04],        # a normal episode, truncated at the horizon
    [-0.04, 0.03, -0.02, 0.01],
], np.float32)
RESET = np.array([0.01, -0.02, 0.03, -0.04], np.float32)
B = len(INITIAL)


class FixedJaxCartPole(JaxCartPole):
    def initial_physics(self, key, eval_mode):
        return JaxPhysics(*(jnp.full(B, v) for v in RESET))


class FixedCartPole(CartPole):
    def initial_physics(self, generator, eval_mode):
        return CartPolePhysics(*(torch.full((B,), float(v)) for v in RESET))


def _close(ours, ref, what):
    np.testing.assert_allclose(np.asarray(ours, np.float32), np.asarray(ref, np.float32), rtol=TOL, atol=TOL,
                               err_msg=what)


def test_trajectories_across_the_termination_boundary_match_jax():
    jenv, env = FixedJaxCartPole(B, HORIZON), FixedCartPole(B, HORIZON, device="cpu")
    jstate = jenv.reset(jax.random.PRNGKey(0))
    jstate = jstate.replace(physics=JaxPhysics(*(jnp.asarray(c) for c in INITIAL.T)))
    state = env.reset(0)
    state = state.replace(physics=CartPolePhysics(*(torch.tensor(c) for c in INITIAL.T)))
    rng = np.random.default_rng(0)
    terminated = truncated = 0
    for t in range(STEPS):
        action = rng.integers(0, 2, size=B).astype(np.int32)
        action[0], action[1] = 1, 0   # push the carts on through the walls
        jstate = jenv.step(jstate, jnp.asarray(action))
        state = env.step(state, torch.tensor(action))
        for field in ("terminated", "truncated"):
            assert np.array_equal(getattr(state, field).numpy(), np.asarray(getattr(jstate, field))), (t, field)
        for field in ("observation", "final_observation", "reward"):
            _close(getattr(state, field), getattr(jstate, field), f"step {t}: {field}")
        for k in ("rollout/episode_return", "rollout/episode_length"):
            _close(state.info[k], jstate.info[k], f"step {t}: {k}")
        if t == 0:   # resting on the boundary is not past it
            assert not state.terminated[4:6].any()
        terminated += int(state.terminated.sum())
        truncated += int(state.truncated.sum())
    assert terminated >= 4 and truncated >= 1, (terminated, truncated)


def test_spaces_and_reset():
    env = create_env(make_config("ppo.cuda", "classic.cart_pole.cuda", **{"runner.device": "cpu"}))[0]
    assert env.single_observation_space.shape == (4,)
    assert env.single_action_space.n == 2 and env.single_action_space.shape == ()
    assert env.horizon == 500 and env.nr_envs == 8
    state = env.reset(3)
    assert state.observation.shape == (8, 4) and (state.observation.abs() < 0.05).all()
    generator = torch.Generator().manual_seed(0)
    actions = env.single_action_space.sample(generator, (1000,))
    assert actions.dtype == torch.int32 and set(actions.tolist()) == {0, 1}
