"""The port's Pendulum (classic.pendulum.cuda on CPU tensors) against the
JAX Pendulum from the same initial state and the same actions: observation,
reward, truncation at the horizon and the auto-reset's final_observation.
f32 on both sides; ``sin``/``cos`` and the angle wrap round alike, but a
trajectory of 30 steps lets the last bits drift: rtol=atol=1e-5."""

import numpy as np
import pytest
import torch

from rlx_tpu_torch.config import create_env, make_config
from rlx_tpu_torch.environments.classic.pendulum.cuda.environment import Pendulum, PendulumPhysics
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

B, HORIZON, STEPS = 8, 25, 30
TOL = 1e-5


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float32), np.asarray(b, dtype=np.float32),
                               rtol=TOL, atol=TOL, err_msg=what)


def test_dynamics_match_jax():
    import jax
    import jax.numpy as jnp

    from rlx_tpu.environments.classic.pendulum.tpu.environment import Pendulum as JaxPendulum
    from rlx_tpu.environments.classic.pendulum.tpu.environment import PendulumPhysics as JaxPhysics

    rng = np.random.default_rng(0)
    theta = rng.uniform(-np.pi, np.pi, size=B).astype(np.float32)
    theta[0] = 3.1   # near the wrap of the angle
    theta_dot = rng.uniform(-1, 1, size=B).astype(np.float32)
    theta_dot[1] = 7.9   # into the speed clip
    jenv, env = JaxPendulum(B, HORIZON), Pendulum(B, HORIZON, device="cpu")
    jstate = jenv.reset(jax.random.PRNGKey(0))
    jstate = jstate.replace(physics=JaxPhysics(jnp.asarray(theta), jnp.asarray(theta_dot)))
    jstate = jstate.replace(observation=jenv.observe(jstate.physics))
    state = env.reset(0)
    state = state.replace(physics=PendulumPhysics(torch.tensor(theta), torch.tensor(theta_dot)))
    state = state.replace(observation=env.observe(state.physics))
    _close(state.observation, jstate.observation, "initial observation")

    for t in range(STEPS):
        # torques beyond the +-2 limit exercise the clip
        action = rng.uniform(-3, 3, size=(B, 1)).astype(np.float32)
        jstate = jenv.step(jstate, jnp.asarray(action))
        state = env.step(state, torch.tensor(action))
        done = np.asarray(jstate.truncated)
        assert np.array_equal(state.truncated.numpy(), done), t
        assert not state.terminated.any()
        _close(state.reward, jstate.reward, f"reward, step {t}")
        _close(state.final_observation, jstate.final_observation, f"final_observation, step {t}")
        for k in ("rollout/episode_return", "rollout/episode_length"):
            _close(state.info[k], jstate.info[k], f"{k}, step {t}")
        if done.any():   # the reset states come from different random streams
            assert t == HORIZON - 1
            break
        _close(state.observation, jstate.observation, f"observation, step {t}")
    else:
        pytest.fail("the horizon never truncated")


def test_spaces_and_reset():
    env = create_env(make_config("ppo.cuda", "classic.pendulum.cuda", **{"runner.device": "cpu"}))[0]
    assert env.single_observation_space.shape == (3,) and env.single_action_space.shape == (1,)
    assert env.single_action_space.low.tolist() == [-2.0] and env.single_action_space.high.tolist() == [2.0]
    state = env.reset(3)
    assert state.observation.shape == (8, 3)
    assert (state.physics.theta.abs() <= np.pi).all() and (state.physics.theta_dot.abs() <= 1.0).all()
    torch.testing.assert_close(state.observation[:, 0] ** 2 + state.observation[:, 1] ** 2, torch.ones(8))
