"""The port's soccer env (``locomotion.soccer.cuda``) against the JAX
package's (``locomotion.soccer.tpu``), Booster T1 on the plane at B=4, in
float64 on both sides as the robot env's test (``test_torch_robot_env.py``
says why), with every draw of the JAX env replayed into the port's:

- the reset, then three steps across a termination and a truncation that
  gains a curriculum level (every field, 1e-5; the 4 gait features in both
  index sets);
- the gait manager: a masked episode start (train and eval mode), the
  phase features, the reward phase of a standing command, and its step;
- the soccer reward's foot terms and the whole reward with its info keys on
  the physical quantities of a stepped state.
"""

import numpy as np
import pytest
import torch

from rlx_tpu_torch.environments.locomotion.soccer.cuda.default_config import get_config
from rlx_tpu_torch.environments.locomotion.soccer.cuda.environment import SoccerEnv
from torch_robot_parity import close_tree, configs, jax_env, port_state, record_draws, replay, run_steps, to64
from torch_robot_parity import float64  # noqa: F401 (module fixture: float64 on both sides)
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

B = 4
TOL = 1e-5


@pytest.fixture(scope="module")
def envs(float64):
    from rlx_tpu.environments.locomotion.soccer.tpu.default_config import get_config as jax_get_config
    from rlx_tpu.environments.locomotion.soccer.tpu.environment import SoccerEnv as JaxSoccerEnv

    jconfig, config = configs(jax_get_config, get_config, "locomotion.soccer", {"nr_envs": B})
    jenv, jreset, jstep = jax_env(JaxSoccerEnv, jconfig)
    return jenv, jreset, jstep, SoccerEnv(config, B, device="cpu")


def test_reset_matches_jax(envs):
    import jax

    jenv, jreset, _, env = envs
    jstate, draws = jreset(jax.random.PRNGKey(3), False)
    state = env.reset(0, draws=replay(draws))
    close_tree(state.physics, dict(jstate.physics), TOL, "reset physics")
    close_tree(state.info, dict(jstate.info), TOL, "reset info")
    np.testing.assert_allclose(state.observation.numpy(), np.asarray(jstate.observation), rtol=TOL, atol=TOL)
    assert state.observation.shape == (B, 98)
    assert (len(env.policy_observation_indices), len(env.critic_observation_indices)) == (82, 98)
    np.testing.assert_array_equal(env.policy_observation_indices, np.asarray(jenv.policy_observation_indices))
    np.testing.assert_array_equal(env.critic_observation_indices, np.asarray(jenv.critic_observation_indices))
    assert env.policy_observation_indices[-4:].tolist() == list(range(94, 98))


def test_steps_match_jax(envs):
    jenv, jreset, jstep, env = envs
    state = run_steps(jenv, jreset, jstep, env, teleport=False)
    assert {"reward/feet_flat", "reward/feet_phase", "reward/feet_yaw"} <= set(state.info)


@pytest.mark.parametrize("eval_mode", [False, True])
def test_gait_matches_jax(envs, eval_mode):
    import jax
    import jax.numpy as jnp

    jenv, jreset, jstep, env = envs
    jstate, _ = jreset(jax.random.PRNGKey(8), False)
    jinternal = dict(to64(jstate.physics)["internal"])
    jinternal["env_curriculum_coeff"] = jnp.asarray([0.0, 0.4, 0.7, 1.0])
    goals = np.asarray(jinternal["goal_velocities"]).copy()
    goals[2] = 0.0  # a standing command
    jinternal["goal_velocities"] = jnp.asarray(goals)
    internal = {k: torch.tensor(np.asarray(v)) for k, v in jinternal.items()}
    mask = np.asarray([True, True, False, True])
    key = jax.random.PRNGKey(9)
    ref, draws = record_draws(lambda: jenv.gait_manager.episode_start(jinternal, jnp.asarray(mask), key,
                                                                      eval_mode))()
    out = env.gait_manager.episode_start(internal, torch.tensor(mask), replay(draws), eval_mode)
    close_tree(out, ref, TOL, "episode start")
    close_tree(env.gait_manager.phase_features(out), jenv.gait_manager.phase_features(ref), TOL, "features")
    close_tree(env.gait_manager.phase_for_reward(out), jenv.gait_manager.phase_for_reward(ref), TOL, "phase")
    assert float(env.gait_manager.phase_for_reward(out)[2, 0]) == pytest.approx(np.pi)
    close_tree(env.gait_manager.step(out), jenv.gait_manager.step(ref), TOL, "step")


def test_soccer_reward_matches_jax(envs):
    import jax
    import jax.numpy as jnp

    jenv, jreset, jstep, env = envs
    jstate, _ = jreset(jax.random.PRNGKey(10), False)
    jstate = to64(jstate)
    action = np.random.default_rng(11).uniform(-1, 1, size=(B, env.nr_actuator_joints))
    jstate = to64(jstep(jstate, jnp.asarray(action))[0])
    state = port_state(jstate)
    jinternal = dict(jstate.physics["internal"])
    jinternal["env_curriculum_coeff"] = jnp.asarray([0.25, 0.5, 0.75, 1.0])
    internal = {k: torch.tensor(np.asarray(v)) for k, v in jinternal.items()}
    jphys, phys = jstate.physics, state.physics
    jobs = jenv._physical_quantities(jphys["qpos"], jphys["qvel"], jinternal, jnp.asarray(action))
    obs = env._physical_quantities(phys["qpos"], phys["qvel"], internal, torch.tensor(action))
    close_tree(obs, dict(jobs), TOL, "physical quantities")
    jinfo, info = {}, {}
    close_tree(env.reward_function.extra_terms(internal, obs, torch.tensor(action), info)[0],
               jenv.reward_function.extra_terms(jinternal, jobs, jnp.asarray(action), jinfo)[0], TOL, "feet phase")
    close_tree(info, jinfo, TOL, "foot terms")
    jreward, jdiff = jenv.reward_function.reward_and_info(jinternal, jobs, jnp.asarray(action), jinfo)
    reward, diff = env.reward_function.reward_and_info(internal, obs, torch.tensor(action), info)
    close_tree({"reward": reward, "xy": diff, **info}, {"reward": jreward, "xy": jdiff, **jinfo}, TOL, "reward")
    assert float(torch.abs(info["reward/feet_phase"]).sum()) > 0.0
