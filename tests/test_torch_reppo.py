"""The port's REPPO against the JAX package's:

- the policy's and the critic's forward passes on converted parameters
  (1e-5: flax's LayerNorm takes the variance as E[x^2] - E[x]^2, torch's
  in two passes), and ``log_prob_at`` against ``REPPO._log_prob`` with
  actions at and beyond +-1 (1e-6);
- ``td_lambda_targets`` against the JAX package's reverse ``lax.scan``,
  with terminations (1e-6);
- one learning iteration on a small Pendulum (4 envs x 8 steps, 2 epochs
  of 2 minibatches) from the same parameters, normalizer and env state,
  with every draw of JAX's keys injected (the rollout's normals, the
  permutations, the reparameterized and the KL samples): every logged
  metric, both nets and the normalizer after it (1e-5), in float64 on
  both sides: the sampled KL is a difference of log-probabilities taken
  back through ``arctanh`` near +-1, where f32 leaves it 2e-3 relative
  apart between the packages;
- save, load bit for bit and test mode through the ``Runner``; the
  defaults; ``nr_parallel_seeds`` above 1 raises.
"""

import numpy as np
import pytest
import torch

from rlx_tpu_torch import convert
from rlx_tpu_torch.algorithms.reppo.cuda.reppo import log_prob_at, td_lambda_targets
from rlx_tpu_torch.config import make_config
from rlx_tpu_torch.runner.runner import Runner
from torch_parity import close, models, normals, np_tree, same_tree
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

NR_ENVS, NR_STEPS, EPOCHS, MINIBATCHES = 4, 8, 2, 2
SMALL = {"environment.nr_envs": NR_ENVS, "algorithm.nr_steps": NR_STEPS, "algorithm.nr_epochs": EPOCHS,
         "algorithm.nr_minibatches": MINIBATCHES, "algorithm.policy_hidden_dim": 16, "algorithm.critic_hidden_dim": 16,
         "algorithm.nr_bins": 31, "algorithm.v_min": -50.0, "algorithm.v_max": 10.0, "algorithm.nr_kl_samples": 4,
         "algorithm.kl_bound": 0.02, "algorithm.total_timesteps": NR_ENVS * NR_STEPS, "environment.horizon": 200,
         "algorithm.evaluation_active": False}


def _perturbed(params, rng):
    import jax

    return jax.tree.map(lambda a: a * rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)
                        + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)


def test_nets_and_log_prob_match_jax():
    import jax.numpy as jnp

    jmodel, model = models("reppo", SMALL)
    rng = np.random.default_rng(0)
    policy_params = _perturbed(jmodel.policy_state.params, rng)
    critic_params = _perturbed(jmodel.critic_state.params, rng)
    model.policy.load_state_dict(convert.reppo_policy_state_dict(np_tree(policy_params)))
    model.critic.load_state_dict(convert.reppo_critic_state_dict(np_tree(critic_params)))
    obs = (2.0 * rng.normal(size=(32, 3))).astype(np.float32)
    action = np.tanh(2.0 * rng.normal(size=(32, 1))).astype(np.float32)
    for ours, ref in zip(model.policy(torch.tensor(obs)), jmodel.policy.apply(policy_params, jnp.asarray(obs))):
        close(ours, ref, 1e-5, "policy")
    for ours, ref in zip(model.critic(torch.tensor(obs), torch.tensor(action)),
                         jmodel.critic.apply(critic_params, jnp.asarray(obs), jnp.asarray(action))):
        close(ours, ref, 1e-5, "critic")
    loc, log_std = (0.5 * rng.normal(size=(32, 1))).astype(np.float32), (-rng.random((32, 1))).astype(np.float32)
    action[:4] = [[1.0], [-1.0], [1.5], [0.9999999]]
    close(log_prob_at(*(torch.tensor(x) for x in (loc, log_std, action))), jmodel._log_prob(loc, log_std, action),
          1e-6, "log_prob_at")


def test_td_lambda_targets_match_jax():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    rewards, next_values = (rng.normal(size=(9, 5)).astype(np.float32) for _ in range(2))
    terminations = (rng.random((9, 5)) < 0.2).astype(np.float32)
    gamma, lam = 0.97, 0.9

    def td_lambda(next_target, inputs):   # the JAX package's reppo.py
        reward, termination, next_value = inputs
        target = reward + gamma * (1.0 - termination) * ((1.0 - lam) * next_value + lam * next_target)
        return target, target

    _, ref = jax.lax.scan(td_lambda, jnp.asarray(next_values[-1]),
                          (jnp.asarray(rewards), jnp.asarray(terminations), jnp.asarray(next_values)), reverse=True)
    ours = td_lambda_targets(*(torch.tensor(x) for x in (rewards, terminations, next_values)), gamma, lam)
    close(ours, ref, 1e-6, "TD(lambda) targets")


def _jax_draws(key, batch_size, mb):
    """The draws of JAX's learning iteration from its carry key."""
    import jax

    act, nxt = [], []
    for _ in range(NR_STEPS):
        key, act_key, next_key = jax.random.split(key, 3)
        act.append(normals(act_key, (NR_ENVS, 1)))
        nxt.append(normals(next_key, (NR_ENVS, 1)))
    key, epochs_key = jax.random.split(key)
    permutations, sample_noise, kl_noise = [], [], []
    for epoch_key in jax.random.split(epochs_key, EPOCHS):
        shuffle_key, mb_key = jax.random.split(epoch_key)
        permutations.append(torch.tensor(np.asarray(jax.random.permutation(shuffle_key, batch_size))))
        sample_noise.append([]), kl_noise.append([])
        for _ in range(MINIBATCHES):
            mb_key, sample_key, kl_key = jax.random.split(mb_key, 3)
            sample_noise[-1].append(normals(sample_key, (mb, 1)))
            kl_noise[-1].append(normals(kl_key, (4, mb, 1)))
    return {"act_noise": torch.stack(act), "next_noise": torch.stack(nxt), "permutations": torch.stack(permutations),
            "sample_noise": sample_noise, "kl_noise": kl_noise}


def test_learning_iteration_matches_jax():
    import jax
    import jax.numpy as jnp

    from rlx_tpu.environments.classic.pendulum.tpu.environment import PendulumPhysics as JaxPhysics
    from rlx_tpu_torch.environments.classic.pendulum.cuda.environment import PendulumPhysics

    jmodel, model = models("reppo", {**SMALL, "algorithm.logging_active": True})
    rng = np.random.default_rng(2)
    model.policy.load_state_dict(convert.reppo_policy_state_dict(np_tree(jmodel.policy_state.params)))
    model.critic.load_state_dict(convert.reppo_critic_state_dict(np_tree(jmodel.critic_state.params)))
    theta = rng.uniform(-np.pi, np.pi, size=NR_ENVS)
    theta_dot = rng.uniform(-1, 1, size=NR_ENVS)
    jenv, env = jmodel.train_env, model.train_env
    logged = []
    jmodel._log_train_callback = lambda metrics, step: logged.append({k: float(v) for k, v in metrics.items()})
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(True):
        to64 = lambda tree: jax.tree.map(lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating)
                                         else a, tree)
        jstate = to64(jenv.reset(jax.random.PRNGKey(0)))
        jstate = jstate.replace(physics=JaxPhysics(jnp.asarray(theta), jnp.asarray(theta_dot)))
        jstate = jstate.replace(observation=jenv.observe(jstate.physics))
        carry = (to64(jmodel.policy_state), to64(jmodel.critic_state), to64(jmodel.obs_normalizer), jstate, key)
        (policy_state, critic_state, obs_normalizer, _, _), _ = jax.jit(
            lambda c: jmodel._learning_iteration(c, 0, 0))(carry)
        jax.effects_barrier()
        draws = _jax_draws(key, NR_ENVS * NR_STEPS, NR_ENVS * NR_STEPS // MINIBATCHES)
    model.policy.double()
    model.critic.double()
    model.obs_normalizer = {k: v.double() for k, v in model.obs_normalizer.items()}
    state = env.reset(0)
    state = state.replace(physics=PendulumPhysics(torch.tensor(theta), torch.tensor(theta_dot)))
    state = state.replace(observation=env.observe(state.physics))
    _, metrics = model.learning_iteration(state, draws)
    (ref,) = logged
    assert set(metrics) == set(ref) - {"time/sps", "steps/nr_env_steps"}
    for k in metrics:
        close(float(metrics[k]), ref[k], 1e-5, k)
    tree = model.checkpoint_tree()
    for name, convert_fn, params in (("policy", convert.reppo_policy_state_dict, policy_state.params),
                                     ("critic", convert.reppo_critic_state_dict, critic_state.params)):
        for k, v in convert_fn(np_tree(params)).items():
            torch.testing.assert_close(tree[name][k], v.double(), rtol=1e-5, atol=1e-5,
                                       msg=lambda m: f"{name} {k}: {m}")
    for k, v in np_tree(obs_normalizer).items():
        close(tree["obs_normalizer"][k], v, 1e-6, f"normalizer {k}")


def test_runner_save_load_and_test(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ["--algorithm.name=reppo.cuda", "--environment.name=classic.pendulum.cuda", "--runner.device=cpu",
            "--environment.nr_envs=4", "--algorithm.nr_steps=8", "--algorithm.nr_epochs=1",
            "--algorithm.nr_minibatches=2", "--algorithm.policy_hidden_dim=16", "--algorithm.critic_hidden_dim=16",
            "--algorithm.total_timesteps=64", "--algorithm.evaluation_and_save_frequency=32",
            "--environment.horizon=20"]
    trained = Runner([*args, "--runner.save_model=True", "--runner.run_name=train"]).run()
    assert [int(s) for s in trained.eval_history["steps"]] == [32, 64]
    assert len(trained.metrics_history) == 2
    assert all(np.isfinite(v) for m in trained.metrics_history for v in m.values())
    models_dir = tmp_path / "runs" / "rlx_tpu_torch" / "default" / "train" / "models"
    assert sorted(p.name for p in models_dir.iterdir()) == ["latest.model"]
    tester = Runner([*args, "--runner.mode=test", f"--runner.load_model={models_dir / 'latest.model'}",
                     "--runner.nr_test_episodes=3", "--runner.run_name=test"])
    returns = tester.run()
    assert len(returns) == 3 and all(np.isfinite(returns))
    tree = trained.checkpoint_tree()
    assert set(tree) == {"policy", "critic", "obs_normalizer"}
    assert same_tree(tree, tester.model.checkpoint_tree()) == len(tree["policy"]) + len(tree["critic"]) + 3


def test_defaults_and_parallel_seeds():
    import importlib

    ref = importlib.import_module("rlx_tpu.algorithms.reppo.tpu.default_config").get_config("x").to_dict()
    ours = dict(make_config("reppo.cuda", "classic.pendulum.cuda").algorithm)
    assert ours.pop("name") == "reppo.cuda" and ours == {k: v for k, v in ref.items() if k != "name"}
    with pytest.raises(NotImplementedError, match="Queue A item 19"):
        Runner(["--algorithm.name=reppo.cuda", "--runner.device=cpu", "--algorithm.nr_parallel_seeds=2"]).run()
