"""Helpers shared by the parity tests of the port's robot and soccer envs.

The JAX env draws from keys split per purpose; the port's env draws from a
``Draws`` in the same program order.  ``record_draws`` wraps a JAX function
so that it also returns every ``jax.random.uniform`` / ``randint`` /
``bernoulli`` value it drew, in call order (under ``jax.jit`` too: the
values are traced outputs); the port replays them through ``ReplayDraws``.
"""

import numpy as np
import pytest
import torch

from rlx_tpu_torch import convert
from rlx_tpu_torch.environments.locomotion.robot.cuda.draws import ReplayDraws

RANDOM_CALLS = ("uniform", "randint", "bernoulli")


def record_draws(fn):
    def recorded(*args, **kwargs):
        import jax

        draws = []
        originals = {name: getattr(jax.random, name) for name in RANDOM_CALLS}

        def recorder(call):
            def record(*a, **k):
                value = call(*a, **k)
                draws.append(value)
                return value
            return record

        try:
            for name, call in originals.items():
                setattr(jax.random, name, recorder(call))
            out = fn(*args, **kwargs)
        finally:
            for name, call in originals.items():
                setattr(jax.random, name, call)
        return out, draws

    return recorded


def replay(draws):
    return ReplayDraws([np.array(d) for d in draws], "cpu")


def jax_env(env_class, config):
    import jax

    env = env_class(config, config.nr_envs)
    return env, jax.jit(record_draws(env.reset), static_argnums=1), jax.jit(record_draws(env.step))


def configs(jax_get_config, port_get_config, name, overrides):
    """(JAX env config, port env config) with the same dotted overrides."""
    jconfig, config = jax_get_config(f"{name}.tpu"), port_get_config(f"{name}.cuda")
    for dotted, value in overrides.items():
        *path, leaf = dotted.split(".")
        for c in (jconfig, config):
            node = c
            for part in path:
                node = node[part]
            node[leaf] = value
    return jconfig, config


def close_tree(ours, ref, tol, what):
    """Every leaf of the port's dict tree against the JAX one's (the same
    keys; bools and ints equal, floats within ``tol``)."""
    if isinstance(ref, dict):
        assert set(ours) == set(ref), (what, sorted(set(ours) ^ set(ref)))
        for k in ref:
            close_tree(ours[k], ref[k], tol, f"{what}/{k}")
        return
    got, want = ours.detach().cpu().numpy(), np.asarray(ref)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "bi":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def close_state(state, jstate, tol, what):
    for field in ("observation", "final_observation", "reward", "terminated", "truncated"):
        close_tree(getattr(state, field), getattr(jstate, field), tol, f"{what} {field}")
    close_tree(state.physics, dict(jstate.physics), tol, f"{what} physics")
    close_tree(state.info, dict(jstate.info), tol, f"{what} info")
    close_tree(state.episode_store, dict(jstate.episode_store), tol, f"{what} episode_store")


def port_state(jstate):
    return convert.env_state_from_jax(jstate)


@pytest.fixture(scope="module")
def float64():
    """JAX's x64 mode and torch's float64 default for a test module (the
    env computes in torch's default float type)."""
    import jax

    x64 = jax.config.jax_enable_x64
    dtype = torch.get_default_dtype()
    jax.config.update("jax_enable_x64", True)
    torch.set_default_dtype(torch.float64)
    yield
    jax.config.update("jax_enable_x64", x64)
    torch.set_default_dtype(dtype)


def to64(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def borderline_contacts(env, state):
    """[B, nf] feet whose clearance over the ground is below 1e-6 in the
    pose of ``state`` (what an auto-reset's lift leaves exactly touching)."""
    feet = env.feet_world_positions(state.physics["qpos"])
    ground = env.terrain_function.height_at(state.physics["internal"], feet[..., 0], feet[..., 1])
    return torch.abs(feet[..., 2] - env.foot_radius - ground) < 1e-6


def close_env_state(env, state, jstate, tol, what):
    """``close_state``, with the contact channel of a foot an auto-reset
    left exactly on the ground taken from JAX's observation."""
    done = state.terminated | state.truncated
    observation = state.observation.clone()
    skip = borderline_contacts(env, state) & done[:, None]
    columns = env.feet_ground_contact_obs_idx
    ref = torch.as_tensor(np.array(jstate.observation))
    observation[:, columns] = torch.where(skip, ref[:, columns], observation[:, columns])
    assert int(skip.sum()) <= 2 * int(done.sum())
    close_state(state.replace(observation=observation), jstate, tol, what)
    assert state.observation.dtype == torch.float64 and np.asarray(jstate.observation).dtype == np.float64


def pushed(jenv, jstate, teleport):
    """The JAX state with the curriculum set per env and envs pushed toward
    a termination (env 0), an edge teleport (env 1, with ``teleport``) and
    a truncation that gains a curriculum level (env 3)."""
    import jax.numpy as jnp

    physics = dict(jstate.physics)
    internal = dict(physics["internal"])
    internal["env_curriculum_coeff"] = jnp.asarray([0.3, 0.6, 0.9, 1.0])
    internal["env_curriculum_levels_in_a_row"] = jnp.asarray([2.0, -1.0, 0.0, 3.0])
    # below the termination height
    qpos = physics["qpos"].at[0, 2].add(-0.7 * jenv.nominal_qpos_height_over_ground)
    if teleport and jenv.terrain_function.half_extent_m < 10.0:  # a heightfield's last half meter
        qpos = qpos.at[1, 0].set(jenv.terrain_function.half_extent_m - 0.3)
    physics.update(qpos=qpos, internal=internal)
    store = dict(jstate.episode_store)
    store["episode_length"] = jnp.asarray([5.0, 5.0, 5.0, float(jenv.horizon - 1)])
    store["episode_total_xy_velocity_diff_abs"] = jnp.asarray([1.0, 1.0, 1.0, 0.0])
    return to64(jstate.replace(physics=physics, episode_store=store))


def run_steps(jenv, jreset, jstep, env, teleport, nr_steps=3, tol=1e-5):
    """Reset JAX, push the state (``pushed``), carry it to the port and step
    both ``nr_steps`` times with the same actions and JAX's draws, comparing
    every field after each step; the first step's events are asserted.
    An env's pose after an auto-reset is carried on from JAX's.  Returns the
    port's last state."""
    import jax
    import jax.numpy as jnp

    jstate, _ = jreset(jax.random.PRNGKey(4), False)
    jstate = pushed(jenv, jstate, teleport)
    state = port_state(jstate)
    B = env.nr_envs
    rng = np.random.default_rng(5)
    for i in range(nr_steps):
        action = rng.uniform(-1.0, 1.0, size=(B, env.nr_actuator_joints))
        jstate, draws = jstep(jstate, jnp.asarray(action))
        jstate = to64(jstate)
        with torch.no_grad():
            state = env.step(state, torch.tensor(action), draws=replay(draws))
        close_env_state(env, state, jstate, tol, f"step {i}")
        assert set(state.info) == set(dict(jstate.info))
        done = state.terminated | state.truncated
        carried = port_state(jstate)
        for name in ("qpos", "contact_anchor"):
            state.physics[name][done] = carried.physics[name][done]
        if i == 0:
            assert state.terminated.tolist() == [True, False, False, False]
            assert state.truncated.tolist() == [False, False, False, True]
            levels = state.physics["internal"]["env_curriculum_levels_in_a_row"]
            coefficient = state.info["env_curriculum/coefficient"]
            assert levels.tolist() == [-1.0, -1.0, 0.0, 4.0]
            assert float(coefficient[3]) == 1.0 and abs(float(coefficient[0]) - 0.29) < 1e-12
            if teleport and env.terrain_function.half_extent_m < 10.0:  # moved back from the edge
                assert abs(float(state.physics["qpos"][1, 0])) < 3.0
            assert not bool(done[1])
            assert 0.0 < float(state.info["rollout/episode_tracking"][3]) <= 1.0
            assert not torch.equal(state.final_observation[0], state.observation[0])
    return state
