"""The port's env wrappers against the JAX package's, on Pendulum: a reset,
then steps that cross an auto-reset at the horizon, with the same actions.
Both sides' Pendulum returns the same fixed initial state at every reset
(the two random streams differ), so every field is compared on every step:
observation, final_observation (built from the window or memory as it was
before the reset), reward, the done flags, and the wrapper's own state
(window, memory, last action).  The randomization wrapper gets JAX's noise
and delay draws, replayed from the JAX state's key.  f32 on both sides over
a few Pendulum steps: rtol=atol=1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlx_tpu.environments import wrappers as jax_wrappers
from rlx_tpu.environments.classic.pendulum.tpu.environment import Pendulum as JaxPendulum
from rlx_tpu.environments.classic.pendulum.tpu.environment import PendulumPhysics as JaxPhysics
from rlx_tpu_torch.config import create_env, make_config
from rlx_tpu_torch.environments import wrappers
from rlx_tpu_torch.environments.classic.pendulum.cuda.environment import Pendulum, PendulumPhysics
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

B, HORIZON, STEPS = 4, 3, 5
TOL = 1e-5
THETA = np.array([3.0, -1.2, 0.4, 2.2], np.float32)
THETA_DOT = np.array([0.5, -0.9, 7.5, 0.0], np.float32)


class FixedJaxPendulum(JaxPendulum):
    def initial_physics(self, key, eval_mode):
        return JaxPhysics(jnp.asarray(THETA), jnp.asarray(THETA_DOT))


class FixedPendulum(Pendulum):
    def initial_physics(self, generator, eval_mode):
        return PendulumPhysics(torch.tensor(THETA), torch.tensor(THETA_DOT))


WRAPPERS = {
    "window": lambda w, env: w.ObservationWindowWrapper(env, 3),
    "mask": lambda w, env: w.ObservationMaskWrapper(env, [0, 1]),
    "memory": lambda w, env: w.MemoryActionsWrapper(env, 2, memory_clip=1.5),
    "window over mask": lambda w, env: w.ObservationWindowWrapper(w.ObservationMaskWrapper(env, [0, 1]), 2),
    "randomization": lambda w, env: w.DomainRandomizationWrapper(env, observation_noise_std=0.1,
                                                                 action_delay_chance=0.5),
}


def _close(ours, ref, what):
    np.testing.assert_allclose(np.asarray(ours, np.float32), np.asarray(ref, np.float32), rtol=TOL, atol=TOL,
                               err_msg=what)


def _compare(state, jstate, what):
    for field in ("observation", "final_observation", "reward"):
        _close(getattr(state, field), getattr(jstate, field), f"{what}: {field}")
    for field in ("terminated", "truncated"):
        assert np.array_equal(getattr(state, field).numpy(), np.asarray(getattr(jstate, field))), (what, field)
    if isinstance(jstate.physics, dict):
        assert set(state.physics) == set(jstate.physics)
        for key in jstate.physics:
            if key != "inner":
                _close(state.physics[key], jstate.physics[key], f"{what}: {key}")


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_reset_and_steps_across_an_autoreset_match_jax(name):
    jenv = WRAPPERS[name](jax_wrappers, FixedJaxPendulum(B, HORIZON))
    env = WRAPPERS[name](wrappers, FixedPendulum(B, HORIZON, device="cpu"))
    assert env.single_observation_space.shape == jenv.single_observation_space.shape
    assert env.single_action_space.shape == jenv.single_action_space.shape
    np.testing.assert_array_equal(env.single_action_space.low.numpy(), np.asarray(jenv.single_action_space.low))
    np.testing.assert_array_equal(env.single_action_space.high.numpy(), np.asarray(jenv.single_action_space.high))
    randomized = name == "randomization"

    key = jax.random.PRNGKey(3)
    jstate = jenv.reset(key)
    reset_draws = {}
    if randomized:   # the wrapper's reset splits its noise key off first
        noise_key = jax.random.split(key)[1]
        reset_draws["noise"] = torch.tensor(np.asarray(jax.random.normal(noise_key, (B, 3))))
    state = env.reset(0, **reset_draws)
    _compare(state, jstate, "reset")

    rng = np.random.default_rng(0)
    action_dim = env.single_action_space.shape[0]
    crossed = False
    for t in range(STEPS):
        action = rng.uniform(-3.0, 3.0, size=(B, action_dim)).astype(np.float32)
        step_draws = {}
        if randomized:   # the wrapper's step splits its delay and noise keys off first
            _, delay_key, noise_key = jax.random.split(jstate.key, 3)
            step_draws["delay_draw"] = torch.tensor(np.asarray(jax.random.uniform(delay_key, (B,))))
            step_draws["noise"] = torch.tensor(np.asarray(jax.random.normal(noise_key, (B, 3))))
        jstate = jenv.step(jstate, jnp.asarray(action))
        state = env.step(state, torch.tensor(action), **step_draws)
        _compare(state, jstate, f"step {t}")
        crossed |= bool(state.truncated.any())
    assert crossed, "no auto-reset in the trajectory"


def test_window_and_memory_at_the_autoreset():
    """At the auto-reset the window starts afresh from the new observation
    while final_observation still ends with the pre-reset one; the memory is
    zeroed in the observation and kept in final_observation."""
    env = wrappers.ObservationWindowWrapper(FixedPendulum(B, 1, device="cpu"), 2)
    state = env.step(env.reset(0), torch.zeros(B, 1))
    assert state.truncated.all()
    fresh = env.env.observe(env.env.initial_physics(None, False))
    torch.testing.assert_close(state.observation, torch.cat([fresh, fresh], dim=1))
    torch.testing.assert_close(state.final_observation[:, :3], fresh)
    assert not torch.equal(state.final_observation[:, 3:], fresh)

    env = wrappers.MemoryActionsWrapper(FixedPendulum(B, 1, device="cpu"), 2, memory_clip=1.5)
    state = env.step(env.reset(0), torch.full((B, 3), 4.0))
    assert (state.observation[:, 3:] == 0).all() and (state.final_observation[:, 3:] == 1.5).all()


def test_mask_velocity_builds_the_masked_pendulum():
    train_env, eval_env = create_env(make_config("ppo.cuda", "classic.pendulum.cuda", **{
        "runner.device": "cpu", "environment.mask_velocity": True}))
    assert train_env is not eval_env
    for env in (train_env, eval_env):
        assert isinstance(env, wrappers.ObservationMaskWrapper)
        assert env.single_observation_space.shape == (2,) and env.single_action_space.shape == (1,)
        state = env.reset(1)
        torch.testing.assert_close(state.observation, env.env.reset(1).observation[:, :2])
