"""The port's Ant (locomotion.ant.cuda on CPU tensors) against the JAX Ant
from identical physics states and actions: observation, reward,
termination, truncation, info, and the masked auto-reset with
final_observation.  f32: rtol=atol=1e-5.  Then the eval-mode episode
return of an Ant that stands for the 200 steps of an episode, in both
packages."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rlx_tpu.environments.locomotion.ant.tpu.environment import Ant as JaxAnt
from rlx_tpu.environments.locomotion.ant.tpu.environment import AntPhysics as JaxAntPhysics
from rlx_tpu_torch.environments.locomotion.ant.cuda.environment import Ant, AntPhysics
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

RTOL = ATOL = 1e-5
B, HORIZON = 8, 20


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float32), np.asarray(b, dtype=np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _states(seed):
    jenv, env = JaxAnt(B, horizon=HORIZON), Ant(B, horizon=HORIZON, device="cpu")
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(jenv.model.qpos0), (B, 1)).astype(np.float32)
    qpos[:, 7:] += rng.normal(scale=0.1, size=(B, 8))
    qpos[0, 2] = 1.5   # above the termination height
    qpos[1, 2] = 1.3   # above it
    qvel = rng.normal(scale=0.3, size=(B, 14)).astype(np.float32)
    ctrl = np.tile(np.asarray(jenv.model.qpos0[7:]), (B, 1)).astype(np.float32)
    length = np.zeros(B, np.float32)
    length[2] = HORIZON - 1  # truncates on this step
    ret = rng.normal(size=B).astype(np.float32)

    jstate = jenv.reset(jax.random.PRNGKey(0))
    jstate = jstate.replace(
        physics=JaxAntPhysics(jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(ctrl)),
        episode_store={"episode_return": jnp.asarray(ret), "episode_length": jnp.asarray(length)},
    )
    state = env.reset(0)
    state = state.replace(
        physics=AntPhysics(torch.tensor(qpos), torch.tensor(qvel), torch.tensor(ctrl)),
        episode_store={"episode_return": torch.tensor(ret), "episode_length": torch.tensor(length)},
    )
    action = rng.uniform(-1.0, 1.0, size=(B, 8)).astype(np.float32)
    return jenv, jstate, env, state, action


def test_reset_matches_jax():
    jenv, env = JaxAnt(B, horizon=HORIZON), Ant(B, horizon=HORIZON, device="cpu")
    jstate, state = jenv.reset(jax.random.PRNGKey(1)), env.reset(1)
    _close(state.observation, jstate.observation, "observation")
    assert env.single_observation_space.shape == jenv.single_observation_space.shape == (34,)
    assert env.single_action_space.shape == jenv.single_action_space.shape == (8,)
    _close(env.single_action_space.low, jenv.single_action_space.low, "action low")
    _close(env.single_action_space.high, jenv.single_action_space.high, "action high")
    for k in jstate.info:
        _close(state.info[k], jstate.info[k], k)


def test_transition_matches_jax():
    jenv, jstate, env, state, action = _states(2)
    jphys, jrew, jterm, jinfo = jenv.transition(jstate.physics, jnp.asarray(action), jax.random.PRNGKey(0))
    phys, rew, term, info = env.transition(state.physics, torch.tensor(action), state.generator)
    for name, a, b in zip(("qpos", "qvel", "ctrl"), phys, jphys):
        _close(a, b, name)
    _close(rew, jrew, "reward")
    np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
    for k in jinfo:
        _close(info[k], jinfo[k], k)
    _close(env.observe(phys), jenv.observe(jphys), "observation")


def test_step_autoreset_matches_jax():
    """Envs 0 and 1 terminate, env 2 truncates: their observation is the
    reset pose while final_observation keeps the pre-reset one."""
    jenv, jstate, env, state, action = _states(3)
    jout = jenv.step(jstate, jnp.asarray(action))
    out = env.step(state, torch.tensor(action))
    done = np.asarray(jout.terminated) | np.asarray(jout.truncated)
    assert done[:3].all() and not done[3:].any()
    np.testing.assert_array_equal(out.terminated.numpy(), np.asarray(jout.terminated))
    np.testing.assert_array_equal(out.truncated.numpy(), np.asarray(jout.truncated))
    _close(out.observation, jout.observation, "observation")
    _close(out.final_observation, jout.final_observation, "final_observation")
    _close(out.reward, jout.reward, "reward")
    for name, a, b in zip(("qpos", "qvel", "ctrl"), out.physics, jout.physics):
        _close(a, b, name)
    for k in jout.info:
        _close(out.info[k], jout.info[k], k)
    for k in jout.episode_store:
        _close(out.episode_store[k], jout.episode_store[k], k)
    # the reset envs restart from the home pose
    home = env.observe(env.initial_physics(state.generator, False))
    torch.testing.assert_close(out.observation[:3], home[:3])
    assert not torch.allclose(out.final_observation[:3], home[:3])


def test_noise_and_perturbation_options_run():
    env = Ant(4, horizon=10, initial_state_noise=0.1, perturbation_chance=1.0, device="cpu")
    state = env.reset(5)
    assert not torch.allclose(state.physics.qpos[0], state.physics.qpos[1])
    physics, *_ = env.transition(state.physics, torch.zeros(4, 8), state.generator)
    assert torch.isfinite(physics.qvel).all()
    eval_state = env.reset(5, eval_mode=True)
    torch.testing.assert_close(eval_state.physics.qpos[0], eval_state.physics.qpos[1])


def test_ant_eval_return_of_a_standing_ant_matches_jax():
    """An Ant that holds zero action for the 200 steps of an eval episode
    stands far from its target velocity and earns exp(-|v_target - v|^2 /
    0.25) ~ 1e-7 a step on the tracking reward: ~2.25e-05 over the
    episode in both packages (a return printed as 0.00 is this value)."""
    from rlx_tpu.config import create_env as jax_create_env
    from rlx_tpu.config import make_config as jax_make_config
    from rlx_tpu_torch.config import create_env, make_config

    nr_envs, horizon = 4, 200
    _, jenv = jax_create_env(jax_make_config("ppo.tpu", "locomotion.ant.tpu", **{
        "environment.nr_envs": nr_envs, "environment.horizon": horizon}))
    _, env = create_env(make_config("ppo.cuda", "locomotion.ant.cuda", **{
        "runner.device": "cpu", "environment.nr_envs": nr_envs, "environment.horizon": horizon}))
    jstate = jax.jit(jenv.reset, static_argnames="eval_mode")(jax.random.PRNGKey(0), eval_mode=True)
    state = env.reset(0, eval_mode=True)
    jstep = jax.jit(jenv.step)
    zeros = jnp.zeros((nr_envs, 8))
    with torch.inference_mode():
        for _ in range(horizon):
            jstate = jstep(jstate, zeros)
            state = env.step(state, torch.zeros(nr_envs, 8))
    assert bool(state.truncated.all()) and bool(np.asarray(jstate.truncated).all())
    ours = state.info["rollout/episode_return"].numpy()
    ref = np.asarray(jstate.info["rollout/episode_return"])
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    assert np.all((ours > 1e-5) & (ours < 1e-4)), ours
