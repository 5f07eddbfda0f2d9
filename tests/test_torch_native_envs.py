"""The port's native C++ env batchers against the JAX package's, from the
same seed and the same actions, at tolerance 0: the classic-control
batcher over several episodes (auto-reset, episode statistics), the MuJoCo
and dm_control batchers with their ``set_state`` / ``get_state`` hooks; the
``g++`` build path; the host edge's tensors on the CPU; and the registry's
host names against the JAX package's."""

import os

import numpy as np
import pytest
import torch

from rlx_tpu.environments.native import batcher as jax_batcher
from rlx_tpu_torch.config import create_env, make_config
from rlx_tpu_torch.environments.native import batcher
from rlx_tpu_torch.ops import _build
from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_NAMES = sorted(
    ".".join(os.path.relpath(d, os.path.join(REPO, "rlx_tpu", "environments")).split(os.sep))
    for d, _, files in os.walk(os.path.join(REPO, "rlx_tpu", "environments"))
    if os.path.basename(d) == "host" and "__init__.py" in files
)


def _actions(rng, env, steps):
    space = env.single_action_space
    if hasattr(space, "n"):
        return rng.integers(0, space.n, size=(steps, env.nr_envs)).astype(np.int32)
    low, high = space.low.numpy(), space.high.numpy()
    return rng.uniform(1.2 * low, 1.2 * high, size=(steps, env.nr_envs) + tuple(space.shape)).astype(np.float32)


@pytest.mark.parametrize("env_id", ["cart_pole", "pendulum"])
def test_classic_batcher_matches_jax_bit_for_bit(env_id):
    """500 steps of random actions (pendulum: 2.5 episodes of 200 steps;
    cart_pole: dozens of terminations), then the same through the env
    protocol: the state's tensors equal the host arrays, and a kept state
    is not rewritten by the next step."""
    rng = np.random.default_rng(0)
    jax_env = jax_batcher.NativeEnvBatch(env_id, 5, seed=11, nr_threads=2)
    env = batcher.NativeEnvBatch(env_id, 5, seed=11, nr_threads=2)
    actions = _actions(rng, env, 500)
    assert np.array_equal(jax_env._host_reset(0), env._host_reset(0))
    episodes = 0
    for t, action in enumerate(actions):
        ref, ours = jax_env._host_step(action), env._host_step(action)
        for name, r, o in zip(("obs", "final", "reward", "terminated", "truncated", "stats"), ref, ours):
            assert o.dtype == r.dtype and np.array_equal(o, r), (t, name)
        done = ours[3] | ours[4]
        episodes += int(done.sum())
        if done.any():   # the finished episode's length surfaces in the stats
            assert (ours[5][done, 1] > 0).all()
    assert episodes >= 2 * env.nr_envs

    # the env protocol: tensors on the CPU, fresh each step
    state = env.reset(0)
    jax_env._host_reset(0)
    kept = None
    for t, action in enumerate(actions[:50]):
        state = env.step(state, torch.from_numpy(action))
        obs, final, reward, terminated, truncated, stats = jax_env._host_step(action)
        assert torch.equal(state.observation, torch.from_numpy(obs))
        assert torch.equal(state.final_observation, torch.from_numpy(final))
        assert torch.equal(state.reward, torch.from_numpy(reward))
        assert torch.equal(state.terminated, torch.from_numpy(terminated))
        assert torch.equal(state.truncated, torch.from_numpy(truncated))
        assert torch.equal(state.info["rollout/episode_length"], torch.from_numpy(stats[:, 1]))
        if t == 10:
            kept = (state, obs.copy(), final.copy(), reward.copy())
    assert torch.equal(kept[0].observation, torch.from_numpy(kept[1]))
    assert torch.equal(kept[0].final_observation, torch.from_numpy(kept[2]))
    assert torch.equal(kept[0].reward, torch.from_numpy(kept[3]))
    assert state.observation.dtype == torch.float32 and state.terminated.dtype == torch.bool
    env.close()
    jax_env.close()


@pytest.mark.parametrize("kind,task", [("mujoco", "hopper"), ("mujoco", "half_cheetah"), ("mujoco", "walker2d"),
                                       ("dmc", "cheetah_run"), ("dmc", "walker_walk"), ("dmc", "walker_run")])
def test_mujoco_and_dmc_batchers_match_jax_bit_for_bit(kind, task):
    """120 steps of random actions beyond the control range, then a state
    set through the hook in both and 10 more steps: every output and the
    state read back equal bit for bit."""
    pytest.importorskip("mujoco")
    if kind == "dmc":
        pytest.importorskip("dm_control")
    classes = {"mujoco": "MujocoNativeEnvBatch", "dmc": "DMCNativeEnvBatch"}[kind]
    jax_env = getattr(jax_batcher, classes)(task, 3, seed=5, nr_threads=2)
    env = getattr(batcher, classes)(task, 3, seed=5, nr_threads=2)
    assert env.horizon == jax_env.horizon and env.single_action_space.shape == jax_env.single_action_space.shape
    np.testing.assert_array_equal(env.single_action_space.low.numpy(), np.asarray(jax_env.single_action_space.low))
    rng = np.random.default_rng(1)
    actions = _actions(rng, env, 130)
    assert np.array_equal(jax_env._host_reset(0), env._host_reset(0))
    for t, action in enumerate(actions):
        if t == 120:
            import mujoco

            model = mujoco.MjModel.from_binary_path(env._model_path(task)) if kind == "dmc" else \
                mujoco.MjModel.from_xml_path(env._model_path(task, None))
            qpos, qvel = env.get_state(1, model.nq, model.nv)
            jqpos, jqvel = jax_env.get_state(1, model.nq, model.nv)
            assert np.array_equal(qpos, jqpos) and np.array_equal(qvel, jqvel)
            qpos = qpos + 0.01 * rng.normal(size=model.nq)
            qvel = qvel + 0.1 * rng.normal(size=model.nv)
            env.set_state(1, qpos, qvel)
            jax_env.set_state(1, qpos, qvel)
            assert np.array_equal(env.get_state(1, model.nq, model.nv)[0], qpos)
        for name, r, o in zip(("obs", "final", "reward", "terminated", "truncated", "stats"),
                              jax_env._host_step(action), env._host_step(action)):
            assert o.dtype == r.dtype and np.array_equal(o, r), (t, name)
    env.close()
    jax_env.close()


def test_unknown_envs_raise():
    with pytest.raises(ValueError, match="unknown native env"):
        batcher.NativeEnvBatch("mountain_car", 2)
    pytest.importorskip("mujoco")
    with pytest.raises(ValueError, match="unknown native"):
        batcher.MujocoNativeEnvBatch("swimmer", 2, xml_path=batcher.MujocoNativeEnvBatch._model_path("hopper", None))


def test_host_build_hashes_flags_and_raises_with_the_compiler_output(tmp_path):
    """The library's name carries a hash of the source and the flags; a
    source that does not compile raises with g++'s message, and nothing is
    left in the build directory."""
    source = os.path.join(batcher.NATIVE_DIR, "envbatch.cpp")
    path = _build.host_library_path(source, [], ["-lpthread"])
    assert os.path.dirname(path) == _build.BUILD_DIR and os.path.basename(path).startswith("envbatch-")
    assert _build.host_library_path(source, ["-DX"], ["-lpthread"]) != path
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" int f() { return undeclared_name; }\n')
    with pytest.raises(RuntimeError, match="undeclared_name"):
        _build.load_host(str(bad))
    stem = os.path.basename(_build.host_library_path(str(bad)))
    assert not [f for f in os.listdir(_build.BUILD_DIR) if f.startswith(stem)]


def test_every_jax_host_name_is_registered():
    """The port registers the JAX package's 20 host names with their ``host``
    leaf; of the JAX registrations only the playground's is left."""
    assert len(HOST_NAMES) == 20
    for name in HOST_NAMES:
        config = make_config("ppo.cuda", name, **{"runner.device": "cpu"})
        assert config.environment.name == name
    from rlx_tpu_torch.environments.environment_manager import get_environment_general_properties
    from rlx_tpu_torch.environments.types import DataInterfaceType, SimulationType

    for name in HOST_NAMES:
        properties = get_environment_general_properties(name)
        assert properties.simulation_type == SimulationType.HOST
        assert properties.data_interface_type == DataInterfaceType.TORCH
    jax_names = set()
    for d, _, files in os.walk(os.path.join(REPO, "rlx_tpu", "environments")):
        if os.path.basename(d) in ("host", "tpu") and "__init__.py" in files:
            jax_names.add(".".join(os.path.relpath(d, os.path.join(REPO, "rlx_tpu", "environments")).split(os.sep)))
    assert len(jax_names) == 28
    missing = set()
    for name in jax_names:
        try:
            make_config("ppo.cuda", name.replace(".tpu", ".cuda"), **{"runner.device": "cpu"})
        except ValueError:
            missing.add(name)
    assert missing == {"playground.g1_joystick_flat_terrain.tpu"}


def test_native_env_registration_seeds_and_device():
    """The eval env's seed is the train env's xor 0x5EED0E7A; both sit on
    ``runner.device``."""
    config = make_config("ppo.cuda", "native.cart_pole.host", **{"runner.device": "cpu",
                                                                "environment.nr_envs": 3})
    train_env, eval_env = create_env(config)
    ref_train = jax_batcher.NativeEnvBatch("cart_pole", 3, seed=1)
    ref_eval = jax_batcher.NativeEnvBatch("cart_pole", 3, seed=1 ^ 0x5EED_0E7A)
    assert torch.equal(train_env.reset(0).observation, torch.from_numpy(ref_train._host_reset(0)))
    assert torch.equal(eval_env.reset(0).observation, torch.from_numpy(ref_eval._host_reset(0)))
    assert train_env.device == torch.device("cpu") and train_env.single_action_space.n == 2
    for env in (train_env, eval_env, ref_train, ref_eval):
        env.close()
