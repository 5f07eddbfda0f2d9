"""The slice as a whole: algorithms on host envs.

- One PPO learning iteration on ``native.pendulum.host`` against JAX's,
  from converted parameters, with JAX's rollout actions injected (both
  native batchers then step bit for bit alike) and JAX's permutations: the
  rollout, the log-probabilities, every parameter and every metric.
- Short runs through the Runner: discrete PPO and C51 on
  ``native.cart_pole.host``, SAC on ``gym.mujoco.hopper_v5.host``; each
  finite and logged, with an evaluation, a save, and test mode from the
  saved model (every tensor restored bit for bit).
"""

import os

import jax
import numpy as np
import pytest
import torch

from rlx_tpu_torch import convert
from rlx_tpu_torch.config import create_model, make_config
from rlx_tpu_torch.runner.runner import Runner
from torch_parity import np_tree, one_torch_thread, same_tree  # noqa: F401  (autouse fixture)

NR_ENVS, NR_STEPS, MINIBATCH, EPOCHS = 4, 8, 16, 2
# f32 on both sides: Adam's first steps move each weight by ~lr, so the
# parameters are compared at 1e-5 absolute, as the PPO parity test does
TOL = 1e-5
PPO = {
    "environment.nr_envs": NR_ENVS,
    "algorithm.nr_steps": NR_STEPS,
    "algorithm.minibatch_size": MINIBATCH,
    "algorithm.nr_epochs": EPOCHS,
    "algorithm.total_timesteps": NR_ENVS * NR_STEPS,
    "algorithm.policy_hidden_sizes": (16, 16),
    "algorithm.critic_hidden_sizes": (16, 16),
    "algorithm.entropy_coef": 0.01,
    "algorithm.evaluation_active": False,
}


def test_ppo_learning_iteration_on_the_native_pendulum_matches_jax(monkeypatch):
    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config

    jmodel = jax_create_model(jax_make_config("ppo.tpu", "native.pendulum.host", **PPO,
                                              **{"runner.mesh_dp": 1, "algorithm.logging_active": True}))
    model = create_model(make_config("ppo.cuda", "native.pendulum.host", **PPO, **{"runner.device": "cpu"}))
    model.policy.module.load_state_dict(convert.policy_state_dict(np_tree(jmodel.policy_state.params)))
    model.critic.load_state_dict(convert.critic_state_dict(np_tree(jmodel.critic_state.params)))

    scans, logged = [], []
    real_scan = jax.lax.scan

    def recording_scan(f, *args, **kwargs):   # traced under jit: record when the program runs
        out = real_scan(f, *args, **kwargs)
        jax.debug.callback(lambda values, name=f.__name__: scans.append((name, values)), out)
        return out

    monkeypatch.setattr(jax.lax, "scan", recording_scan)
    monkeypatch.setattr(jmodel, "_log_train_callback", lambda metrics, *_: logged.append(np_tree(metrics)))
    env_state = jmodel.train_env.reset(jax.random.PRNGKey(1))
    policy_state, critic_state, _, _ = jax.block_until_ready(jax.jit(jmodel._learning_iteration)(
        (jmodel.policy_state, jmodel.critic_state, env_state, jax.random.PRNGKey(2)), 0, 0))[0]
    jax.effects_barrier()
    monkeypatch.undo()
    (_, _, _, key), (observations, final_observations, actions, rewards, terminations, log_probs, _) = \
        dict(scans)["single_rollout_step"]

    # the port's rollout takes JAX's actions; the log-probabilities are its own
    injected = iter(torch.tensor(np.asarray(actions)))

    def sample_and_log_prob(obs, generator=None, noise=None):
        action = next(injected)
        return action, model.policy.log_prob_entropy(obs, action)[0]

    model.policy = model.policy._replace(sample_and_log_prob=sample_and_log_prob)
    _, opt_key = jax.random.split(key)
    _, perm_key = jax.random.split(opt_key)
    batch = NR_ENVS * NR_STEPS
    epoch_indices = torch.tensor(np.asarray(jax.random.permutation(
        perm_key, np.tile(np.arange(batch), (EPOCHS, 1)), axis=1, independent=True)))
    optimize = model._optimize
    model._optimize = lambda arrays: optimize(arrays, epoch_indices=epoch_indices)
    rollouts = []
    rollout = model._rollout
    model._rollout = lambda state: rollouts.append(rollout(state)) or rollouts[-1]
    _, metrics = model.learning_iteration(model.train_env.reset(0))

    (_, ours, _), = rollouts
    for name, got, ref in zip(("observations", "final observations", "rewards", "terminations"),
                              (ours[0], ours[1], ours[3], ours[4]),
                              (observations, final_observations, rewards, terminations)):
        assert torch.equal(got, torch.tensor(np.asarray(ref))), name
    assert float(np.abs(np.asarray(rewards)).sum()) > 0.0
    torch.testing.assert_close(ours[5], torch.tensor(np.asarray(log_probs)), rtol=TOL, atol=TOL)
    for name, ref in convert.policy_state_dict(np_tree(policy_state.params)).items():
        torch.testing.assert_close(model.policy.module.state_dict()[name], ref, rtol=TOL, atol=TOL,
                                   msg=lambda m: f"policy {name}: {m}")
    for name, ref in convert.critic_state_dict(np_tree(critic_state.params)).items():
        torch.testing.assert_close(model.critic.state_dict()[name], ref, rtol=TOL, atol=TOL,
                                   msg=lambda m: f"critic {name}: {m}")
    (jmetrics,) = logged
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-4, atol=TOL, err_msg=k)
    model.train_env.close()
    jmodel.train_env.close()


@pytest.mark.parametrize("algorithm,environment,nr_envs,evaluations,args", [
    ("ppo", "native.cart_pole.host", 4, 2, ["--algorithm.nr_steps=16", "--algorithm.minibatch_size=32",
                                         "--algorithm.nr_epochs=2", "--algorithm.total_timesteps=256",
                                         "--algorithm.evaluation_and_save_frequency=128"]),
    ("c51", "native.cart_pole.host", 4, 2, ["--algorithm.learning_starts=64", "--algorithm.batch_size=32",
                                         "--algorithm.total_timesteps=256", "--algorithm.logging_frequency=64",
                                         "--algorithm.evaluation_and_save_frequency=128"]),
    ("sac", "gym.mujoco.hopper_v5.host", 1, 1, ["--algorithm.learning_starts=64", "--algorithm.batch_size=32",
                                                "--algorithm.buffer_size=1024", "--algorithm.total_timesteps=192",
                                                "--algorithm.logging_frequency=64",
                                                "--algorithm.evaluation_and_save_frequency=192",
                                                "--algorithm.policy_hidden_sizes=(32, 32)",
                                                "--algorithm.critic_hidden_sizes=(32, 32)"]),
])
def test_short_runs_through_the_runner_with_evaluation_save_and_load(tmp_path, monkeypatch, algorithm,
                                                                       environment, nr_envs, evaluations, args):
    """Evaluations and saves (an off-policy evaluation runs the env's
    horizon, 1000 steps for the Hopper, so it runs one, on one env, as in
    the JAX records), finite logged metrics, then test mode from
    ``latest.model``: every tensor restored bit for bit."""
    monkeypatch.chdir(tmp_path)
    common = [f"--algorithm.name={algorithm}.cuda", f"--environment.name={environment}", "--runner.device=cpu",
              f"--environment.nr_envs={nr_envs}"]
    trained = Runner([*common, *args, "--runner.save_model=True", "--runner.run_name=host"]).run()
    assert trained.metrics_history
    for metrics in trained.metrics_history:
        assert all(np.isfinite(v) for v in metrics.values()), metrics
    returns = [float(r) for r in trained.eval_history["eval/episode_return"]]
    assert len(returns) == evaluations and all(np.isfinite(returns))
    latest = os.path.join(tmp_path, "runs", "rlx_tpu_torch", "default", "host", "models", "latest.model")
    tester = Runner([*common, "--runner.mode=test", f"--runner.load_model={latest}",
                     "--runner.nr_test_episodes=2", "--runner.run_name=host_test"])
    test_returns = tester.run()
    assert len(test_returns) == 2 and all(np.isfinite(test_returns))
    assert same_tree(trained.checkpoint_tree(), tester.model.checkpoint_tree()) > 0
