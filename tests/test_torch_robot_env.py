"""The port's robot locomotion env (``locomotion.robot.cuda``) against the
JAX package's (``locomotion.robot.tpu``), quadruped at B=4:

- the reset and three steps, on the default heightfield and on the plane,
  with every draw of the JAX env (recorded in call order) replayed into the
  port's (``torch_robot_parity``): the steps start from the JAX reset state
  carried across by ``convert.env_state_from_jax``, with the curriculum
  set per env and three envs pushed into a termination (trunk too low), an
  edge teleport (near the heightfield's edge) and a truncation (the last
  step of an episode tracked well enough to climb a curriculum level).
  The observation, ``final_observation``, reward, flags, every info key,
  the episode store and the whole physics state (pose, velocities, stick
  anchors and every internal entry: terrain, randomization, commands,
  curriculum) agree at rtol=atol=1e-5.  Both sides run in float64: the
  stiff penalty contacts turn f32 rounding into joint velocities 4e-5
  apart after one step.  The reset pose is float32 on both sides (the
  keyframe's type), and the reset lifts it until its lowest foot touches
  the ground exactly; whether that foot then reads contact, and whether
  the first contact of the next step brings its damper force, turns on the
  last bit of float32 forward kinematics, which the two engines round
  differently.  So the contact channel of such a foot in an auto-reset
  observation is not compared, and an env's pose after an auto-reset is
  carried on from JAX's (its other state stays the port's own);
- each randomization, command, sampling and terrain class on its own, with
  the JAX class's draws replayed (1e-5, float64);
- the observation layout and index sets of all five robots.
"""

import numpy as np
import pytest
import torch

from rlx_tpu_torch.environments.locomotion.robot.cuda import components, randomization, terrain
from rlx_tpu_torch.environments.locomotion.robot.cuda.default_config import get_config
from rlx_tpu_torch.environments.locomotion.robot.cuda.environment import LocomotionEnv
from rlx_tpu_torch.environments.locomotion.robot.robots.configs import ROBOT_CONFIGS
from torch_robot_parity import close_tree, configs, jax_env, port_state, record_draws, replay, run_steps, to64
from torch_robot_parity import float64  # noqa: F401 (module fixture: float64 on both sides)
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

B = 4
TOL = 1e-5


def build(terrain_type, robot="quadruped"):
    from rlx_tpu.environments.locomotion.robot.tpu.default_config import get_config as jax_get_config
    from rlx_tpu.environments.locomotion.robot.tpu.environment import LocomotionEnv as JaxLocomotionEnv

    jconfig, config = configs(jax_get_config, get_config, "locomotion.robot",
                              {"nr_envs": B, "robot": robot, "terrain.type": terrain_type})
    jenv, jreset, jstep = jax_env(JaxLocomotionEnv, jconfig)
    return jenv, jreset, jstep, LocomotionEnv(config, B, device="cpu")


@pytest.fixture(scope="module", params=["hfield_diverse", "plane"])
def envs(request, float64):
    return build(request.param)


def test_reset_matches_jax(envs):
    import jax

    jenv, jreset, _, env = envs
    jstate, draws = jreset(jax.random.PRNGKey(3), False)
    state = env.reset(0, draws=replay(draws))
    close_tree(state.physics, dict(jstate.physics), TOL, "reset physics")
    close_tree(state.info, dict(jstate.info), TOL, "reset info")
    np.testing.assert_allclose(state.observation.numpy(), np.asarray(jstate.observation), rtol=TOL, atol=TOL)
    assert state.observation.shape == (B, 61)


def test_steps_match_jax(envs):
    """A termination, an edge teleport (heightfield only: the plane has no
    edge) and a truncation with a curriculum level gained, then two more
    steps."""
    jenv, jreset, jstep, env = envs
    state = run_steps(jenv, jreset, jstep, env, teleport=True)
    assert state.observation.shape == (B, 61)


def _component_inputs(env, state):
    internal = dict(state.physics["internal"])
    internal["env_curriculum_coeff"] = torch.tensor([0.2, 0.5, 0.8, 1.0])
    should = torch.tensor([True, False, True, True])
    return internal, should


def _jax_internal(internal):
    import jax.numpy as jnp

    return {k: jnp.asarray(v.numpy()) for k, v in internal.items()}


COMPONENTS = ("action_delay", "initial_state", "observation_noise", "joint_dropout", "mujoco_model",
              "perturbation", "seen_robot", "unseen_robot", "commands", "terrain", "sampling")


@pytest.fixture(scope="module")
def hfield_pair(float64):
    import jax

    jenv, jreset, _, env = build("hfield_diverse")
    jstate, _ = jreset(jax.random.PRNGKey(6), False)
    return jenv, env, port_state(to64(jstate))


@pytest.mark.parametrize("component", COMPONENTS)
def test_component_matches_jax(component, hfield_pair):
    """One class of each kind on its own, its JAX twin's draws replayed."""
    import jax
    import jax.numpy as jnp

    from rlx_tpu.environments.locomotion.robot.tpu import components as jax_components
    from rlx_tpu.environments.locomotion.robot.tpu import randomization as jax_randomization
    from rlx_tpu.environments.locomotion.robot.tpu import terrain as jax_terrain

    jenv, env, state = hfield_pair
    internal, should = _component_inputs(env, state)
    jinternal, jshould = _jax_internal(internal), jnp.asarray(should.numpy())
    cc, jcc = internal["env_curriculum_coeff"], jinternal["env_curriculum_coeff"]
    key = jax.random.PRNGKey(7)
    qpos, qvel = state.physics["qpos"], state.physics["qvel"]
    jqpos, jqvel = jnp.asarray(qpos.numpy()), jnp.asarray(qvel.numpy())
    drc = env.env_config.domain_randomization

    def both(jax_call, port_call):
        ref, draws = record_draws(jax_call)()
        out = port_call(replay(draws))
        assert len(draws) > 0
        return out, ref

    if component in ("seen_robot", "unseen_robot", "mujoco_model", "joint_dropout", "action_delay"):
        jcls = jax_randomization.get_domain_randomization_function(component, "default", jenv, drc[component])
        cls = randomization.get_domain_randomization_function(component, "default", env, drc[component])
        out, ref = both(lambda: jcls.sample(jinternal, jshould, key, jcc),
                        lambda draws: cls.sample(internal, should, draws, cc))
        close_tree(out, ref, TOL, component)
        if component == "joint_dropout":
            close_tree(cls.kp_mask(out), jcls.kp_mask(ref), 0.0, "kp mask")
            close_tree(cls.damping_mask(out), jcls.damping_mask(ref), 0.0, "damping mask")
        if component == "action_delay":
            action = torch.tensor(np.random.default_rng(8).uniform(-1, 1, (B, env.nr_actuator_joints)))
            jdelayed, jnext = jcls.delay_action(jnp.asarray(action.numpy()), ref)
            delayed, nxt = cls.delay_action(action, out)
            close_tree(delayed, jdelayed, 0.0, "delayed actions")
            close_tree(nxt, jnext, 0.0, "delay buffer")
    elif component == "initial_state":
        jcls = jax_randomization.RandomInitialState(jenv, drc["initial_state"])
        cls = randomization.RandomInitialState(env, drc["initial_state"])
        out, ref = both(lambda: jcls.setup(jinternal, key, jcc), lambda draws: cls.setup(internal, draws, cc))
        close_tree({"qpos": out[0], "qvel": out[1]}, {"qpos": ref[0], "qvel": ref[1]}, TOL, component)
    elif component == "observation_noise":
        jcls = jax_randomization.DefaultObservationNoise(jenv, drc["observation_noise"])
        cls = randomization.DefaultObservationNoise(env, drc["observation_noise"])
        obs = torch.tensor(np.random.default_rng(9).normal(size=(B, 61)))
        out, ref = both(lambda: jcls.modify(jinternal, jnp.asarray(obs.numpy()), key),
                        lambda draws: cls.modify(internal, obs, draws))
        close_tree(out, ref, TOL, component)
    elif component == "perturbation":
        jcls = jax_randomization.DefaultPerturbation(jenv, drc["perturbation"])
        cls = randomization.DefaultPerturbation(env, drc["perturbation"])
        out, ref = both(lambda: jcls.sample(jqpos, jqvel, jinternal, jshould, key),
                        lambda draws: cls.sample(qpos, qvel, internal, should, draws))
        close_tree({"qpos": out[0], "qvel": out[1]}, {"qpos": ref[0], "qvel": ref[1]}, TOL, component)
    elif component == "commands":
        jcls = jax_components.RandomCommands(jenv, env.env_config.command)
        cls = components.RandomCommands(env, env.env_config.command)
        out, ref = both(lambda: jcls.get_next_command(jinternal, jshould, key),
                        lambda draws: cls.get_next_command(internal, should, draws))
        close_tree(out, ref, TOL, component)
    elif component == "terrain":
        jcls = jax_terrain.HFieldDiverseTerrain(jenv, env.env_config.terrain)
        cls = terrain.HFieldDiverseTerrain(env, env.env_config.terrain)
        out, ref = both(lambda: jcls.sample(jinternal, key, jcc), lambda draws: cls.sample(internal, draws, cc))
        close_tree(out, ref, TOL, component)
        xy = torch.tensor(np.random.default_rng(10).uniform(-4.5, 4.5, size=(2, B, 7)))
        close_tree(cls.height_at(out, xy[0], xy[1]), jcls.height_at(ref, *map(jnp.asarray, xy.numpy())), 0.0,
                   "height_at")
    else:  # sampling
        jcls = jax_components.StepProbabilitySampling(jenv, 0.3)
        cls = components.StepProbabilitySampling(env, 0.3)
        out, ref = both(lambda: jcls.step(key, B, jcc), lambda draws: cls.step(draws, B, cc))
        close_tree(out, ref, 0.0, component)


@pytest.mark.parametrize("robot", sorted(ROBOT_CONFIGS))
def test_observation_layout_matches_jax(robot):
    """Observation width, index sets, feet, symmetry pairs and foot groups
    of each robot, on its default heightfield."""
    from rlx_tpu.environments.locomotion.robot.tpu.default_config import get_config as jax_get_config
    from rlx_tpu.environments.locomotion.robot.tpu.environment import LocomotionEnv as JaxLocomotionEnv

    jconfig, config = configs(jax_get_config, get_config, "locomotion.robot", {"nr_envs": B, "robot": robot})
    jenv = JaxLocomotionEnv(jconfig, B)
    env = LocomotionEnv(config, B, device="cpu")
    assert env.single_observation_space.shape == tuple(jenv.single_observation_space.shape)
    np.testing.assert_array_equal(env.policy_observation_indices, np.asarray(jenv.policy_observation_indices))
    np.testing.assert_array_equal(env.critic_observation_indices, np.asarray(jenv.critic_observation_indices))
    np.testing.assert_array_equal(env.feet_symmetry_pairs, jenv.feet_symmetry_pairs)
    assert env.foot_groups == jenv.foot_groups and env.nr_feet == jenv.nr_feet
    assert (env.horizon, env.nr_substeps, env.dt) == (jenv.horizon, jenv.nr_substeps, jenv.dt)
    assert env.nr_collisions_in_nominal == jenv.nr_collisions_in_nominal
    np.testing.assert_allclose(env.ground_penetration_in_nominal.numpy(),
                               np.asarray(jenv.ground_penetration_in_nominal), rtol=TOL, atol=TOL)
    if robot == "quadruped":
        assert (env.single_observation_space.shape[0], len(env.policy_observation_indices),
                len(env.critic_observation_indices)) == (61, 45, 61)
