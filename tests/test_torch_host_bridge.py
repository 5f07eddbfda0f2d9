"""The port's host bridges against the JAX package's: ``HostGymEnv`` in
sync mode on Pendulum-v1 and CartPole-v1 and ``DMCHostEnv`` on
walker/walk at tolerance 0; the thread-pool and process modes with slow-env
skipping (the semantics of ``tests/test_gym_host_bridge.py``); the
process pool's import of numpy only; the Atari wrappers on a fake ALE env
against JAX's, an image PPO iteration through the bridge, and Pong gated
on ``ale_py``; the socket env's round trip."""

import json
import socket
import subprocess
import sys
import threading
import time

import gymnasium as gym
import numpy as np
import pytest
import torch

from rlx_tpu.environments.gym.atari import wrappers as jax_wrappers
from rlx_tpu.environments.gym.host_bridge import HostGymEnv as JaxHostGymEnv
from rlx_tpu_torch.config import create_model, make_config
from rlx_tpu_torch.environments.gym.atari import wrappers
from rlx_tpu_torch.environments.gym.host_bridge import HostGymEnv
from test_atari_wrappers import FakeAtariEnv
from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

FIELDS = ("observation", "final_observation", "reward", "terminated", "truncated", "stats")


@pytest.mark.parametrize("env_id,discrete", [("Pendulum-v1", False), ("CartPole-v1", True)])
def test_sync_gym_bridge_matches_jax_bit_for_bit(env_id, discrete):
    """260 steps (Pendulum crosses its 200-step limit, CartPole terminates
    often): every host output equal bit for bit, then the env protocol's
    tensors equal them."""
    rng = np.random.default_rng(0)
    jax_env, env = JaxHostGymEnv(env_id, 3), HostGymEnv(env_id, 3)
    assert env.horizon == jax_env.horizon
    actions = (rng.integers(0, 2, size=(260, 3)) if discrete
               else rng.uniform(-2.5, 2.5, size=(260, 3, 1)).astype(np.float32))
    assert np.array_equal(jax_env._host_reset(17), env._host_reset(17))
    dones = 0
    for t, action in enumerate(actions):
        refs, ours = jax_env._host_step(action), env._host_step(action)
        for name, r, o in zip(FIELDS, refs, ours):
            assert o.dtype == r.dtype and np.array_equal(o, r), (t, name)
        dones += int((ours[3] | ours[4]).sum())
    assert dones >= 3
    state = env.reset(17)
    jax_env._host_reset(17)
    for action in actions[:20]:
        state = env.step(state, torch.as_tensor(action))
        obs, final, reward, terminated, truncated, stats = jax_env._host_step(action)
        assert torch.equal(state.observation, torch.from_numpy(obs))
        assert torch.equal(state.final_observation, torch.from_numpy(final))
        assert torch.equal(state.reward, torch.from_numpy(reward))
        assert torch.equal(state.terminated, torch.from_numpy(terminated))
        assert torch.equal(state.info["rollout/episode_return"], torch.from_numpy(stats[:, 0]))
    env.close()
    jax_env.close()


def test_thread_pool_skips_the_slow_env_and_lands_its_step_later():
    """Env 0 sleeps 50 ms a step with a quarter of the envs allowed to skip: a
    skipped step repeats its observation with zero reward, and its step
    lands on a later call (its observation moves and its reward is
    nonzero there)."""
    env = HostGymEnv("Pendulum-v1", 4, async_workers=4, async_skip_percentage=0.25)
    inner = env._envs[0]
    original = inner.step

    def slow_step(action):
        time.sleep(0.05)
        return original(action)

    inner.step = slow_step
    state = env.reset(0)
    previous = state.observation[0].clone()
    for _ in range(3):   # env 0's first step is still running: skipped
        state = env.step(state, torch.zeros(4, 1))
        assert torch.equal(state.observation[0], previous) and float(state.reward[0]) == 0.0
        assert (state.reward[1:] != 0.0).all()   # the fast envs step every call
    time.sleep(0.08)
    state = env.step(state, torch.zeros(4, 1))   # ... and lands here
    assert float(state.reward[0]) != 0.0 and not torch.equal(state.observation[0], previous)
    assert torch.isfinite(state.observation).all()
    env.close()


def test_process_mode_auto_resets_and_skips():
    """Forkserver workers behind the bridge: 205 steps cross Pendulum's
    horizon (episode length 200, return < 0 in every env); then a pool with
    one slow worker and a quarter of the envs allowed to skip keeps the
    fast envs moving, gives the skipped env its old observation and zero
    reward, and lands its step later."""
    from rlx_tpu_torch.environments.gym.process_pool import ProcessEnvPool

    env = HostGymEnv("Pendulum-v1", 4, vectorization="process")
    try:
        state = env.reset(0)
        for _ in range(205):
            state = env.step(state, torch.zeros(4, 1))
        assert torch.isfinite(state.observation).all()
        assert (state.info["rollout/episode_length"] == 200.0).all()
        assert (state.info["rollout/episode_return"] < 0.0).all()
    finally:
        env.close()

    class Slow(gym.Wrapper):
        def step(self, action):
            time.sleep(0.3)
            return self.env.step(action)

    fns = [lambda slow=slow: (Slow(gym.make("Pendulum-v1")) if slow else gym.make("Pendulum-v1"))
           for slow in (False, False, False, True)]
    pool = ProcessEnvPool(fns, (3,), np.float32, skip_percentage=0.25)
    try:
        first = pool.reset(0)
        start = time.time()
        out = [pool.step([np.zeros(1, np.float32)] * 4) for _ in range(3)]
        assert time.time() - start < 0.85       # without skipping: >= 0.9 s
        assert np.array_equal(out[0][0][3], first[3]) and out[0][2][3] == 0.0
        assert all((o[2][:3] != 0.0).all() for o in out)
        time.sleep(0.35)
        landed = pool.step([np.zeros(1, np.float32)] * 4)
        assert landed[2][3] != 0.0 and not np.array_equal(landed[1][3], first[3])
    finally:
        pool.close()


def test_process_pool_and_its_packages_import_no_torch():
    code = ("import sys, rlx_tpu_torch.environments.gym.process_pool; "
            "sys.exit(1 if 'torch' in sys.modules else 0)")
    assert subprocess.run([sys.executable, "-c", code], capture_output=True, timeout=120).returncode == 0


def test_dmc_host_env_matches_jax_bit_for_bit():
    pytest.importorskip("dm_control")
    from rlx_tpu.environments.dmc.host_bridge import DMCHostEnv as JaxDMCHostEnv
    from rlx_tpu_torch.environments.dmc.host_bridge import DMCHostEnv

    jax_env, env = JaxDMCHostEnv("walker", "walk", 2, seed=3), DMCHostEnv("walker", "walk", 2, seed=3)
    assert env.horizon == jax_env.horizon == 1000
    assert np.array_equal(jax_env._host_reset(0), env._host_reset(0))
    rng = np.random.default_rng(2)
    for t in range(40):
        action = rng.uniform(-1, 1, size=(2, 6)).astype(np.float32)
        for name, ref, ours in zip(FIELDS, jax_env._host_step(action), env._host_step(action)):
            assert ours.dtype == ref.dtype and np.array_equal(ours, ref), (t, name)
    env.close()
    jax_env.close()


def test_atari_wrappers_match_jax_on_a_fake_ale():
    """The port's stack and JAX's from the same seed under the same actions:
    frames, rewards, flags and the raw episode statistics."""
    ours = wrappers.wrap_atari(FakeAtariEnv(), noop_max=5, skip=4, nr_frames=4)
    ref = jax_wrappers.wrap_atari(FakeAtariEnv(), noop_max=5, skip=4, nr_frames=4)
    a, _ = ours.reset(seed=3)
    b, _ = ref.reset(seed=3)
    assert a.shape == (84, 84, 4) and a.dtype == np.uint8 and np.array_equal(a, b)
    stats_seen = False
    for t in range(40):
        step_a, step_b = ours.step(t % 6), ref.step(t % 6)
        assert np.array_equal(step_a[0], step_b[0]) and step_a[1:4] == step_b[1:4], t
        assert step_a[4].get("episode_return") == step_b[4].get("episode_return")
        stats_seen |= "episode_return" in step_a[4]
        if step_a[2] or step_a[3]:
            a, _ = ours.reset()
            b, _ = ref.reset()
            assert np.array_equal(a, b)
    assert stats_seen


def test_image_ppo_iteration_through_the_bridge_on_a_fake_atari():
    """uint8 [84, 84, 4] frames cross the edge as uint8 and train PPO's
    NatureCNN for one iteration (finite parameters, logged losses)."""
    from rlx_tpu_torch.environments import environment_manager as em
    from rlx_tpu_torch.environments.gym.atari.common import make_atari_registration
    from rlx_tpu_torch.utils.config_dict import ConfigDict

    _, _, properties = make_atari_registration("Fake-v5")

    def create(config):
        fns = [lambda: wrappers.wrap_atari(FakeAtariEnv(), noop_max=2)] * config.environment.nr_envs
        envs = tuple(HostGymEnv("fake", config.environment.nr_envs, env_fns=fns, device=config.runner.device)
                     for _ in range(2))
        for env in envs:
            env.general_properties = properties
            env.horizon = 32
        return envs

    em.register_environment("test.fake_atari.host", lambda name: ConfigDict(name=name, seed=1, nr_envs=2),
                            create, properties)
    model = create_model(make_config("ppo.cuda", "test.fake_atari.host", **{
        "runner.device": "cpu", "environment.nr_envs": 2, "algorithm.nr_steps": 8,
        "algorithm.minibatch_size": 8, "algorithm.nr_epochs": 1, "algorithm.total_timesteps": 16,
        "algorithm.evaluation_active": False}))
    state = model.train_env.reset(0)
    assert state.observation.dtype == torch.uint8 and state.observation.shape == (2, 84, 84, 4)
    model.train()
    assert len(model.metrics_history) == 1
    assert all(np.isfinite(v) for v in model.metrics_history[0].values())
    assert all(torch.isfinite(p).all() for p in model.policy.module.parameters())
    model.train_env.close()


def test_pong_is_registered_and_gated_on_ale_py():
    import rlx_tpu_torch.environments.gym.atari.pong_v5.host as pong

    config = make_config("ppo.cuda", "gym.atari.pong_v5.host", **{"runner.device": "cpu"})
    assert config.environment.type == "Pong-v5" and config.environment.frame_stack == 4
    try:
        import ale_py  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="ale_py"):
            pong.create_train_and_eval_env(config)


def _fake_client(port, steps=200):
    """The reference's wire protocol from the simulator's side: a 1D point
    mass, truncated every 50 steps; the first reaction is the reset's."""
    for _ in range(100):
        try:
            sock = socket.create_connection(("127.0.0.1", port))
            break
        except OSError:
            time.sleep(0.05)
    sock.send(json.dumps({"actionCount": 1, "observationCount": 2}).encode())
    time.sleep(0.2)  # keep the handshake in its own TCP read
    x, v = 0.0, 0.0
    sock.send(json.dumps({"observation": [x, v], "reward": 0.0, "terminated": False, "truncated": False}).encode())
    try:
        for t in range(1, steps + 1):
            data = sock.recv(4096)
            if not data:
                break
            v = 0.9 * v + 0.1 * json.loads(data.decode())["action"][0]
            x = x + 0.1 * v
            sock.send(json.dumps({"observation": [x, v], "reward": -abs(x - 1.0), "terminated": False,
                                  "truncated": t % 50 == 0}).encode())
            if t % 50 == 0:
                x, v = 0.0, 0.0
    except OSError:
        pass
    sock.close()


def test_socket_env_round_trip():
    """The handshake sets the spaces; 60 steps of a constant action cross
    the 50-step truncation, whose episode length reaches ``info``; the
    observation follows the client's dynamics."""
    from rlx_tpu_torch.environments.custom_interface.prototype.connection import SocketEnv

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    client = threading.Thread(target=_fake_client, args=(port,), daemon=True)
    client.start()
    env = SocketEnv("127.0.0.1", port, horizon=50)
    try:
        assert env.single_observation_space.shape == (2,) and env.single_action_space.shape == (1,)
        state = env.reset(0)
        assert torch.equal(state.observation, torch.zeros(1, 2))
        x = v = 0.0
        for t in range(1, 61):
            state = env.step(state, torch.full((1, 1), 0.5))
            v = 0.9 * v + 0.05
            x = x + 0.1 * v
            if t == 50:
                assert bool(state.truncated[0]) and float(state.info["rollout/episode_length"][0]) == 50.0
                x = v = 0.0
            else:
                np.testing.assert_allclose(state.observation[0].numpy(), [x, v], rtol=1e-6, atol=1e-7)
        assert np.isfinite(state.observation.numpy()).all()
    finally:
        env.close()
    client.join(timeout=5)
