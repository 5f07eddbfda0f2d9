"""The port's pixel envs (``classic.pixel_grid.cuda``, ``classic.pixel_chase.cuda``
on CPU tensors) against the JAX package's, from the same initial states and
the same actions.  The two random streams differ, so the JAX env's
``initial_physics`` draws are recorded in call order (one a reset, one a
step, as both packages draw the auto-reset states every step) and handed
back to the port's env.  The first episode starts from a hand-made state:
agents that reach or intercept their goal, goals that wrap at the edges,
agents clipped at a wall, an agent that lands on its goal (255 over 128).
Observations, rewards, the done flags, ``final_observation``, the episode
metrics and the whole physics (the uint8 frame stack included) must be
equal exactly over 40 steps with a short horizon (auto-resets on
termination and truncation)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlx_tpu.environments.classic.pixel_chase.tpu.environment import ChasePhysics as JaxChasePhysics
from rlx_tpu.environments.classic.pixel_chase.tpu.environment import PixelChase as JaxPixelChase
from rlx_tpu.environments.classic.pixel_grid.tpu.environment import GridPhysics as JaxGridPhysics
from rlx_tpu.environments.classic.pixel_grid.tpu.environment import PixelGrid as JaxPixelGrid
from rlx_tpu_torch.config import create_env, make_config
from rlx_tpu_torch.environments.classic.pixel_chase.cuda.environment import ChasePhysics, PixelChase
from rlx_tpu_torch.environments.classic.pixel_grid.cuda.environment import GridPhysics, PixelGrid
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

B, STEPS, HORIZON = 8, 40, 12
UP, DOWN, LEFT, RIGHT = 0, 1, 2, 3
# (agent, goal) per env of the first episode
AGENTS = [[3, 3], [0, 1], [7, 7], [4, 1], [2, 6], [5, 5], [1, 2], [6, 0]]
GOALS = [[3, 5], [0, 7], [7, 0], [4, 2], [0, 6], [5, 6], [6, 2], [7, 7]]
# drift directions of the chase's goals: env 0 comes left towards its agent
# (an interception), env 1 drifts off the right edge and env 2 off the
# bottom edge (wrapping), env 4 up off the top edge
DIRECTIONS = [LEFT, RIGHT, DOWN, UP, UP, RIGHT, LEFT, DOWN]


def _to_torch(physics, cls):
    return cls(*(torch.tensor(np.asarray(v)).long() if np.asarray(v).dtype != np.uint8
                 else torch.tensor(np.asarray(v)) for v in physics))


def _recorded(jax_cls, port_cls, physics_cls):
    """(JAX env class recording its draws, port env class replaying them)."""
    draws = []

    class Recording(jax_cls):
        def initial_physics(self, key, eval_mode):
            physics = super().initial_physics(key, eval_mode)
            draws.append(physics)
            return physics

    class Replaying(port_cls):
        def initial_physics(self, generator, eval_mode):
            return _to_torch(draws.pop(0), physics_cls)

    return Recording, Replaying, draws


def _first_state(env, jenv, physics, jphysics):
    """Both envs reset, then put into the hand-made first episode."""
    jstate = jenv.reset(jax.random.PRNGKey(0))
    state = env.reset(0)
    jstate = jstate.replace(physics=jphysics, observation=jenv.observe(jphysics))
    state = state.replace(physics=physics, observation=env.observe(physics))
    return state, jstate


def _actions(rng, state, t):
    """Random actions, with env 0 walking right for the first steps (onto or
    into its goal) and env 1 pushing up against the wall."""
    action = rng.integers(0, 4, size=B).astype(np.int32)
    if t < 3:
        action[0], action[1] = RIGHT, UP
    return action


def _assert_step_equal(state, jstate, t):
    for field in ("observation", "final_observation", "reward", "terminated", "truncated"):
        ours, ref = getattr(state, field).numpy(), np.asarray(getattr(jstate, field))
        assert ours.dtype == ref.dtype, (t, field, ours.dtype, ref.dtype)
        np.testing.assert_array_equal(ours, ref, err_msg=f"step {t}: {field}")
    for k in ("rollout/episode_return", "rollout/episode_length"):
        np.testing.assert_array_equal(state.info[k].numpy(), np.asarray(jstate.info[k]), err_msg=f"step {t}: {k}")
    for name, ours, ref in zip(state.physics._fields, state.physics, jstate.physics):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref), err_msg=f"step {t}: physics {name}")


def test_pixel_grid_matches_jax():
    Recording, Replaying, draws = _recorded(JaxPixelGrid, PixelGrid, GridPhysics)
    jenv, env = Recording(B, HORIZON), Replaying(B, HORIZON, device="cpu")
    agent, goal = np.array(AGENTS, np.int32), np.array(GOALS, np.int32)
    state, jstate = _first_state(env, jenv, GridPhysics(torch.tensor(agent).long(), torch.tensor(goal).long()),
                                 JaxGridPhysics(jnp.asarray(agent), jnp.asarray(goal)))
    assert state.observation.shape == (B, 84, 84, 1) and state.observation.dtype == torch.float32
    np.testing.assert_array_equal(state.observation.numpy(), np.asarray(jstate.observation))
    # the agent's 10 x 10 block is 255, the goal's 128, the 4-pixel border 0
    obs = state.observation[..., 0]
    assert (obs[0, 30:40, 30:40] == 255).all() and (obs[0, 30:40, 50:60] == 128).all()
    assert (obs[:, 80:, :] == 0).all() and (obs[:, :, 80:] == 0).all()
    rng = np.random.default_rng(0)
    terminated = truncated = 0
    for t in range(STEPS):
        action = _actions(rng, state, t)
        jstate = jenv.step(jstate, jnp.asarray(action))
        state = env.step(state, torch.tensor(action))
        _assert_step_equal(state, jstate, t)
        if t == 1:
            # env 0 stepped onto its goal: +1, terminated, and the final
            # observation shows the agent (255) over the goal (no 128 left)
            assert state.reward[0] == 1.0 and state.terminated[0]
            assert (state.final_observation[0, 30:40, 50:60, 0] == 255).all()
            assert not (state.final_observation[0] == 128).any()
        terminated += int(state.terminated.sum())
        truncated += int(state.truncated.sum())
    assert terminated >= 2 and truncated >= 1, (terminated, truncated)
    assert not draws


@pytest.mark.parametrize("frame_stack,goal_period", [(4, 1), (4, 3), (1, 1)])
def test_pixel_chase_matches_jax(frame_stack, goal_period):
    Recording, Replaying, draws = _recorded(JaxPixelChase, PixelChase, ChasePhysics)
    jenv = Recording(B, HORIZON, frame_stack, goal_period)
    env = Replaying(B, HORIZON, frame_stack, goal_period, device="cpu")
    agent, goal = np.array(AGENTS, np.int32), np.array(GOALS, np.int32)
    direction = np.array(DIRECTIONS, np.int32)
    frame = np.asarray(jenv._render_frame(jnp.asarray(agent), jnp.asarray(goal)))
    frames = np.repeat(frame[..., None], frame_stack, axis=-1)
    step = np.zeros(B, np.int32)
    physics = ChasePhysics(*(torch.tensor(v).long() for v in (agent, goal, direction, step)), torch.tensor(frames))
    jphysics = JaxChasePhysics(*(jnp.asarray(v) for v in (agent, goal, direction, step, frames)))
    state, jstate = _first_state(env, jenv, physics, jphysics)
    assert state.physics.frames.dtype == torch.uint8
    assert state.observation.shape == (B, 84, 84, frame_stack) and state.observation.dtype == torch.float32
    rng = np.random.default_rng(frame_stack + goal_period)
    caught = truncated = 0
    for t in range(STEPS):
        previous = state
        action = _actions(rng, state, t)
        jstate = jenv.step(jstate, jnp.asarray(action))
        state = env.step(state, torch.tensor(action))
        _assert_step_equal(state, jstate, t)
        done = (state.terminated | state.truncated).numpy()
        # the stack rolls: the oldest frame leaves, the newest comes in last
        np.testing.assert_array_equal(state.physics.frames[~done, ..., :-1].numpy(),
                                      previous.physics.frames[~done, ..., 1:].numpy())
        # a fresh episode repeats its first frame
        fresh = state.physics.frames[done]
        assert (fresh == fresh[..., :1]).all()
        # the goal_period gate: a goal moves on the steps that are multiples
        # of goal_period (each env counts from its own episode's start)
        goal_moved = (state.physics.goal != previous.physics.goal).any(dim=1)
        np.testing.assert_array_equal(goal_moved[~done].numpy(),
                                      (state.physics.step % goal_period == 0)[~done].numpy(), err_msg=str(t))
        if t == 0:
            assert state.physics.agent[1].tolist() == [0, 1]   # clipped at the top wall
            if goal_period == 1:
                # env 0 intercepted its goal in the middle: caught; the goals
                # of envs 1, 2 and 4 wrapped over the right, bottom and top edges
                assert state.terminated[0] and state.reward[0] == 1.0
                assert [state.physics.goal[i].tolist() for i in (1, 2, 4)] == [[0, 0], [0, 0], [7, 6]]
        caught += int(state.terminated.sum())
        truncated += int(state.truncated.sum())
    assert truncated >= 1 and (caught >= 1 or goal_period > 1), (caught, truncated)
    assert not draws


def test_pixel_envs_register_with_the_jax_keys():
    """Both registrations carry the JAX package's config keys and defaults,
    and build their envs on the requested device."""
    from rlx_tpu.config import make_config as jax_make_config

    for name in ("pixel_grid", "pixel_chase"):
        config = make_config("dqn.cuda", f"classic.{name}.cuda", **{"runner.device": "cpu"})
        ref = dict(jax_make_config("dqn.tpu", f"classic.{name}.tpu").environment)
        ours = dict(config.environment)
        assert ours.pop("name") == f"classic.{name}.cuda" and ref.pop("name") == f"classic.{name}.tpu"
        assert ours == ref
        train_env, eval_env = create_env(config)
        assert train_env is not eval_env and train_env.device == torch.device("cpu")
        assert train_env.single_observation_space.shape == (84, 84, 4 if name == "pixel_chase" else 1)
