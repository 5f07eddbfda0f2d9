"""The port's ``PlaygroundAdapter`` against the JAX package's, on the CPU:
a torch counterpart of ``tests/test_playground_adapter.py``'s stub
(``FakeBraxEnv``: vector dynamics, episodes of 5 steps ended by
truncation, auto-reset, an obs dict with a privileged suffix) under the
port's adapter gives JAX's adapter's outputs over JAX's stub; the JAX
test's contract, episode statistics and PPO cases on the port; and the
registration ``playground.g1_joystick_flat_terrain.cuda`` raises
``ImportError`` naming mujoco_playground."""

import dataclasses
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlx_tpu_torch.environments.playground.adapter import GeneralProperties, PlaygroundAdapter
from test_playground_adapter import FakeBraxEnv as JaxFakeBraxEnv
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)


@dataclasses.dataclass
class FakeBraxState:
    obs: Dict[str, torch.Tensor]
    reward: torch.Tensor
    done: torch.Tensor
    metrics: Dict[str, torch.Tensor]
    info: Dict[str, torch.Tensor]
    t: torch.Tensor


class FakeBraxEnv:
    """The JAX test's stub in torch, its tensors on ``device``; ``reset``
    takes the adapter's generator (and draws nothing from it)."""

    action_size = 2
    observation_size = {"state": (4,), "privileged_state": (6,)}
    episode_length = 5

    def __init__(self, nr_envs=3, device="cpu"):
        self.nr_envs, self.device = nr_envs, device

    def _obs(self, t):
        base = t[:, None].expand(-1, 4)
        privileged = torch.cat([base, torch.full((t.shape[0], 2), 9.0, device=self.device)], dim=1)
        return {"state": base, "privileged_state": privileged}

    def reset(self, generator):
        assert isinstance(generator, torch.Generator)
        t = torch.zeros(self.nr_envs, device=self.device)
        zeros = torch.zeros(self.nr_envs, device=self.device)
        return FakeBraxState(obs=self._obs(t), reward=zeros, done=zeros, metrics={"speed": zeros},
                             info={"truncation": zeros}, t=t)

    def step(self, state, action):
        t = state.t + 1
        done = t >= self.episode_length
        t = torch.where(done, 0.0, t)   # auto-reset; this stub only ever truncates
        return FakeBraxState(obs=self._obs(t), reward=action.abs().sum(-1), done=done.float(), metrics={"speed": t},
                             info={"truncation": done.float()}, t=t)


def register_stub(name, nr_envs=3):
    """Register the stub under the adapter as the env ``name``."""
    from rlx_tpu_torch.environments import environment_manager as em
    from rlx_tpu_torch.utils.config_dict import ConfigDict

    def create(config):
        env = PlaygroundAdapter(FakeBraxEnv(nr_envs, config.runner.device), nr_envs=nr_envs, horizon=5,
                                device=config.runner.device)
        return env, env

    em.register_environment(name, lambda n: ConfigDict(name=n, seed=1, nr_envs=nr_envs), create, GeneralProperties)


def test_adapter_matches_jax():
    """12 steps of the same actions (two auto-resets): observation, reward,
    terminated, truncated and every rollout/* and env_info/* entry within
    1e-6 of JAX's adapter over JAX's stub."""
    from rlx_tpu.environments.playground.adapter import PlaygroundAdapter as JaxPlaygroundAdapter

    jax_env = JaxPlaygroundAdapter(JaxFakeBraxEnv(), nr_envs=3, horizon=5)
    env = PlaygroundAdapter(FakeBraxEnv(), nr_envs=3, horizon=5, device="cpu")
    jax_state, state = jax_env.reset(jax.random.PRNGKey(0)), env.reset(0)
    actions = np.random.default_rng(0).uniform(-1.5, 1.5, size=(12, 3, 2)).astype(np.float32)
    step = jax.jit(jax_env.step)
    resets = 0
    for t in range(13):
        if t:
            jax_state = step(jax_state, jnp.asarray(actions[t - 1]))
            state = env.step(state, torch.from_numpy(actions[t - 1]))
        for field in ("observation", "final_observation", "reward", "terminated", "truncated"):
            np.testing.assert_allclose(getattr(state, field).numpy(), np.asarray(getattr(jax_state, field)),
                                       rtol=0, atol=1e-6, err_msg=f"step {t} {field}")
        assert set(state.info) == set(jax_state.info) == {
            "rollout/episode_return", "rollout/episode_length", "env_info/speed"}
        for key in jax_state.info:
            np.testing.assert_allclose(state.info[key].numpy(), np.asarray(jax_state.info[key]), rtol=0, atol=1e-6,
                                       err_msg=f"step {t} {key}")
        resets += int(state.truncated.all())
    assert resets == 2


@pytest.fixture()
def env():
    return PlaygroundAdapter(FakeBraxEnv(), nr_envs=3, horizon=5, device="cpu")


def test_adapter_contract(env):
    """As the JAX test's: the policy's indices are the prefix of the
    privileged vector; the spaces sit on the adapter's device."""
    assert env.single_observation_space.shape == (6,)
    np.testing.assert_array_equal(env.policy_observation_indices, np.arange(4))
    np.testing.assert_array_equal(env.critic_observation_indices, np.arange(6))
    assert env.single_action_space.center.device == env.device == torch.device("cpu")
    state = env.reset(0)
    assert state.observation.shape == (3, 6)
    assert float(state.info["env_info/speed"].sum()) == 0.0


def test_adapter_episode_statistics_and_truncation(env):
    """As the JAX test's: the episode ends by truncation, its return and
    length latched at done, the store reset."""
    state = env.reset(0)
    for _ in range(5):
        state = env.step(state, torch.ones(3, 2))
    assert bool(state.truncated.all()) and not bool(state.terminated.any())
    np.testing.assert_allclose(state.info["rollout/episode_return"].numpy(), 10.0)
    np.testing.assert_allclose(state.info["rollout/episode_length"].numpy(), 5.0)
    np.testing.assert_allclose(state.episode_store["episode_return"].numpy(), 0.0)


def test_adapter_trains_with_ppo():
    """As the JAX test's: 2 PPO iterations on the stub (3 envs x 5 steps)
    through the registry, parameters finite."""
    from rlx_tpu_torch.config import create_model, make_config

    register_stub("test.fake_playground.cuda")
    model = create_model(make_config("ppo.cuda", "test.fake_playground.cuda", **{
        "algorithm.total_timesteps": 2 * 3 * 5, "algorithm.nr_steps": 5, "algorithm.minibatch_size": 5,
        "algorithm.nr_epochs": 1, "environment.nr_envs": 3, "runner.device": "cpu"}))
    before = [p.detach().clone() for p in model.policy.module.parameters()]
    model.train()
    after = list(model.policy.module.parameters())
    assert all(torch.isfinite(p).all() for p in after)
    assert any(not torch.equal(a, b) for a, b in zip(after, before))


def test_registration_raises_naming_mujoco_playground():
    """The 28th registration: its config carries the JAX keys; creating the
    env raises ImportError naming mujoco_playground whether or not the
    package imports (a JAX/MJX program, which the port does not import)."""
    import rlx_tpu_torch.environments.playground.g1_joystick_flat_terrain.cuda as pg
    from rlx_tpu_torch.config import create_env, make_config
    from rlx_tpu_torch.environments.environment_manager import registered_environment_names

    config = make_config("ppo.cuda", "playground.g1_joystick_flat_terrain.cuda", **{"runner.device": "cpu"})
    assert "playground.g1_joystick_flat_terrain.cuda" in registered_environment_names()
    assert (config.environment.type, config.environment.nr_envs, config.environment.use_domain_randomization) == (
        "G1JoystickFlatTerrain", 4096, False)
    assert pg.get_config("playground.g1_joystick_flat_terrain.cuda").copy_train_env_for_eval is True
    with pytest.raises(ImportError, match="mujoco_playground"):
        create_env(config)
