"""The port's recurrent PPO family against the JAX package's
``algorithms/recurrent_ppo.py``:

- two whole learning iterations of each of ``ppo_lstm``, ``ppo_gru``,
  ``ppo_mamba2`` and ``ppo_transformer`` against JAX's
  ``_learning_iteration`` from converted parameters, on the masked
  Pendulum with the same fixed initial physics on both sides, horizon 3
  inside an 8-step window (the carry resets mid-window), JAX's own action
  noise and env permutations replayed from its key chain: both nets, the
  carry after each window and every metric at 1e-5, in float64 on both
  sides (JAX's metrics read through its logging callback);
- the defaults, key for key;
- train -> save -> test mode through the Runner (``ppo_lstm``,
  ``ppo_transformer``), with the optimizer state, reloaded bit for bit;
- a JAX recurrent checkpoint carried into the port.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlx_tpu.environments import wrappers as jax_wrappers
from rlx_tpu_torch import convert
from rlx_tpu_torch.config import create_model, make_config
from rlx_tpu_torch.environments import wrappers
from rlx_tpu_torch.environments.classic.pendulum.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.runner.runner import Runner
from rlx_tpu.environments.classic.pendulum.tpu.environment import PendulumPhysics as JaxPhysics
from rlx_tpu_torch.environments.classic.pendulum.cuda.environment import PendulumPhysics
from test_torch_wrappers import THETA, THETA_DOT, FixedJaxPendulum, FixedPendulum
from torch_parity import assert_state_dict, close, np_tree, same_tree
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

ALGORITHMS = ("ppo_lstm", "ppo_gru", "ppo_mamba2", "ppo_transformer")
E, T, HORIZON, EPOCHS, MINIBATCHES = 4, 8, 3, 2, 2
TOL = 1e-5
SMALL = {"algorithm.obs_encoding_dim": 8, "algorithm.rnn_hidden_dim": 4, "algorithm.critic_hidden_sizes": (16, 16)}
CELL = {"ppo_mamba2": {"algorithm.cell_state_dim": 4, "algorithm.cell_conv_kernel": 3},
        "ppo_transformer": {"algorithm.tf_context_len": 4, "algorithm.tf_nr_heads": 2, "algorithm.tf_nr_blocks": 2}}


def _overrides(algorithm):
    return {**SMALL, **CELL.get(algorithm, {}), "environment.nr_envs": E, "algorithm.nr_steps": T,
            "algorithm.nr_epochs": EPOCHS, "algorithm.nr_minibatches": MINIBATCHES,
            "algorithm.total_timesteps": 2 * E * T, "algorithm.learning_rate": 3e-3,
            "algorithm.entropy_coef": 0.01, "algorithm.evaluation_active": False, "algorithm.logging_active": True}


class Pendulum64(FixedPendulum):
    def initial_physics(self, generator, eval_mode):
        return PendulumPhysics(torch.tensor(THETA, dtype=torch.float64), torch.tensor(THETA_DOT, dtype=torch.float64))


class JaxPendulum64(FixedJaxPendulum):
    def initial_physics(self, key, eval_mode):
        return JaxPhysics(jnp.asarray(THETA.astype(np.float64)), jnp.asarray(THETA_DOT.astype(np.float64)))


def _models(algorithm):
    """(JAX model, its env, port model on the CPU in float64, its env), the
    port's nets carrying JAX's parameters."""
    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config

    jenv = jax_wrappers.ObservationMaskWrapper(JaxPendulum64(E, HORIZON), [0, 1])
    jmodel = jax_create_model(jax_make_config(f"{algorithm}.tpu", "classic.pendulum.tpu", **_overrides(algorithm),
                                              **{"runner.mesh_dp": 1}), jenv, jenv)
    env = wrappers.ObservationMaskWrapper(Pendulum64(E, HORIZON, device="cpu"), [0, 1])
    env.general_properties = GeneralProperties
    model = create_model(make_config(f"{algorithm}.cuda", "classic.pendulum.cuda", **_overrides(algorithm),
                                     **{"runner.device": "cpu"}), env, env)
    model.policy.load_state_dict(convert.recurrent_policy_state_dict(np_tree(jmodel.policy_state.params)))
    model.critic.load_state_dict(convert.critic_state_dict(np_tree(jmodel.critic_state.params)))
    model.policy.double()
    model.critic.double()
    return jmodel, jenv, model, env


def _jax_draws(key, action_dim):
    """The action normals and env permutations JAX's ``_learning_iteration``
    draws from ``key`` (float64 normals: call under ``enable_x64``)."""
    noise = []
    for _ in range(T):
        key, action_key = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(action_key, (E, action_dim))))
    _, perm_key = jax.random.split(key)
    env_indices = jax.random.permutation(perm_key, jnp.tile(jnp.arange(E), (EPOCHS, 1)), axis=1, independent=True)
    return (torch.tensor(np.stack(noise)),
            torch.tensor(np.asarray(env_indices).reshape(EPOCHS * MINIBATCHES, E // MINIBATCHES)))


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_learning_iterations_match_jax(algorithm):
    """In float64 on both sides: in f32 Adam turns rounding-level gradients
    into steps of the learning rate (one torso weight of 32,768 was 2.2e-5
    apart after the first iteration)."""
    jmodel, jenv, model, env = _models(algorithm)
    logged = []
    jmodel._log_train_callback = lambda metrics, *_: logged.append({k: float(v) for k, v in metrics.items()})
    to64 = lambda tree: jax.tree.map(lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating)
                                     else a, tree)
    env_state, carry = env.reset(0), model.policy.initialize_carry(E)
    with jax.enable_x64(True):
        iteration = jax.jit(lambda c: jmodel._learning_iteration(c, 0, 0)[0])
        jcarry = (to64(jmodel.policy_state), to64(jmodel.critic_state), to64(jenv.reset(jax.random.PRNGKey(0))),
                  to64(jmodel.policy.initialize_carry(E)), jax.random.PRNGKey(5))
        for it in range(2):
            noise, env_indices = _jax_draws(jcarry[4], 1)
            jcarry = jax.block_until_ready(iteration(jcarry))
            jax.effects_barrier()
            env_state, carry, metrics = model.learning_iteration(env_state, carry, noise, env_indices)
            what = f"{algorithm} iteration {it}"
            assert_state_dict(model.policy, convert.recurrent_policy_state_dict(np_tree(jcarry[0].params)), TOL,
                              f"{what} policy")
            assert_state_dict(model.critic, convert.critic_state_dict(np_tree(jcarry[1].params)), TOL,
                              f"{what} critic")
            for ours, ref in zip(jax.tree.leaves(carry), jax.tree.leaves(jcarry[3])):
                assert ours.dtype == torch.float64
                close(ours, ref, TOL, f"{what} carry after the window")
            close(env_state.observation, jcarry[2].observation, TOL, f"{what} observation")
            assert set(metrics) == set(logged[-1]), sorted(set(metrics) ^ set(logged[-1]))
            for k, v in logged[-1].items():
                close(float(metrics[k]), v, TOL, f"{what} {k}")
        count = int(jcarry[0].opt_state[1].count)
    assert model.nr_optimizer_steps == count == 2 * EPOCHS * MINIBATCHES
    assert len(logged) == 2 and logged[-1]["policy_ratio/clip_fraction"] > 0.0


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_defaults_match_jax(algorithm):
    ref = importlib.import_module(f"rlx_tpu.algorithms.{algorithm}.tpu.default_config").get_config("x").to_dict()
    ref.pop("name")
    ours = dict(make_config(f"{algorithm}.cuda", "classic.pendulum.cuda").algorithm)
    assert ours.pop("name") == f"{algorithm}.cuda"
    assert ours == ref


def test_parallel_seeds_raise():
    """Parallel seeds are ported; with logging on (the default) they raise
    the JAX package's ``ValueError``."""
    with pytest.raises(ValueError, match="requires algorithm.logging_active=False"):
        create_model(make_config("ppo_gru.cuda", "classic.pendulum.cuda", **{
            "runner.device": "cpu", "algorithm.nr_parallel_seeds": 2}))


PENDULUM = ["--environment.name=classic.pendulum.cuda", "--runner.device=cpu", "--environment.nr_envs=4",
            "--environment.mask_velocity=True", "--algorithm.nr_steps=8", "--algorithm.nr_minibatches=2",
            "--algorithm.nr_epochs=2", "--algorithm.obs_encoding_dim=8", "--algorithm.rnn_hidden_dim=4",
            "--algorithm.critic_hidden_sizes=(16, 16)"]


@pytest.mark.parametrize("algorithm", ["ppo_lstm", "ppo_transformer"])
def test_train_save_then_test_mode(tmp_path, monkeypatch, algorithm):
    monkeypatch.chdir(tmp_path)
    args = [f"--algorithm.name={algorithm}.cuda", *PENDULUM, "--runner.save_optimizer_state=True"]
    trained = Runner([*args, "--algorithm.total_timesteps=64", "--algorithm.evaluation_and_save_frequency=32",
                      "--runner.save_model=True"]).run()
    models = tmp_path / "runs" / "rlx_tpu_torch" / "default" / "run" / "models"
    assert sorted(os.listdir(models)) == ["best.model", "latest.model"]
    assert len(trained.eval_history["steps"]) == 2 and len(trained.metrics_history) == 2
    assert all(np.isfinite(v) for m in trained.metrics_history for v in m.values())
    runner = Runner([*args, "--runner.mode=test", f"--runner.load_model={models / 'latest.model'}",
                     "--runner.nr_test_episodes=6"])
    returns = runner.run()
    assert len(returns) == 6 and all(np.isfinite(returns))
    assert same_tree(trained.checkpoint_tree(), runner.model.checkpoint_tree()) > 0
    assert runner.model.nr_optimizer_steps == 2 * 2 * 2


@pytest.mark.parametrize("algorithm", ["ppo_mamba2", "ppo_transformer"])
def test_jax_checkpoint_carries_into_the_port(tmp_path, algorithm):
    """A JAX ``latest.model`` of a recurrent PPO, carried across: the port's
    means over a window with dones and its values are JAX's."""
    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config
    from rlx_tpu.utils.checkpoint import load_model_file

    overrides = {**SMALL, **CELL[algorithm], "environment.nr_envs": E, "environment.mask_velocity": True,
                 "algorithm.rnn_obs_combine_method": "film"}
    jmodel = jax_create_model(jax_make_config(f"{algorithm}.tpu", "classic.pendulum.tpu", **overrides, **{
        "runner.mesh_dp": 1, "runner.save_model": True}), run_path=str(tmp_path))
    jmodel.save()
    restored, _ = load_model_file(str(tmp_path / "models" / "latest.model"))
    port = create_model(make_config(f"{algorithm}.cuda", "classic.pendulum.cuda", **overrides,
                                    **{"runner.device": "cpu"}))
    port.restore_from_tree(convert.checkpoint_tree_from_jax(algorithm, np_tree(restored)))
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(6, E, 2)).astype(np.float32)
    dones = (rng.random((6, E)) < 0.3).astype(np.float32)
    jmean, _ = jmodel.policy.apply(jmodel.policy_state.params, obs, dones, jmodel.policy.initialize_carry(E),
                                   method=jmodel.policy.sequence)
    with torch.no_grad():
        mean, _ = port.policy.sequence(torch.tensor(obs), torch.tensor(dones), port.policy.initialize_carry(E))
        close(mean, jmean, TOL, "means")
        close(port.critic(torch.tensor(obs[0])), jmodel.critic.apply(jmodel.critic_state.params, obs[0]), TOL, "values")
