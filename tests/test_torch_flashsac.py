"""The port's FlashSAC against the JAX package's:

- flax's ``nn.BatchNorm(momentum=0.99)`` (train and eval mode, the running
  statistics it returns) and ``project_params`` against the port's;
- two ``update`` calls (step 0 steps the policy, step 1 does not: delay 2)
  from a JAX checkpoint tree carried in (parameters, statistics, noise, a
  non-trivial reward normalizer; ``eval_act`` compared first) and JAX's
  normals replayed: every metric, parameter, running
  statistic, ``log_alpha`` and Adam count after each call (1e-5);
- the Polyak-then-project order of the critic's target;
- the repeated-noise stream of ``pre_act`` with JAX's draws replayed, and
  the warmup-cosine schedule against optax;
- the target projection through the plain version of kernel B3;
- a ``Runner`` save -> load -> test round trip that carries the three
  BatchNorm streams bit for bit.
"""

import numpy as np
import pytest
import torch

from rlx_tpu_torch import convert
from rlx_tpu_torch.algorithms.flashsac.cuda import layers
from rlx_tpu_torch.runner.runner import Runner
from torch_parity import assert_state_dict, batch, close, models, normals, np_tree, same_tree, to_torch
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

ACT, OBS, ATOMS, B = 8, 34, 11, 16
SMALL = {
    "environment.nr_envs": 8,
    "algorithm.batch_size": B,
    "algorithm.nr_atoms": ATOMS,
    "algorithm.policy_hidden_dim": 8,
    "algorithm.critic_hidden_dim": 16,
    "algorithm.policy_nr_blocks": 1,
    "algorithm.critic_nr_blocks": 2,
    "algorithm.evaluation_active": False,
    "algorithm.total_timesteps": 2048,
    "algorithm.learning_starts": 64,
}


def _jax_trees(states):
    p, c = states["policy"], states["critic"]
    return {
        "policy": convert.flashsac_policy_state_dict(np_tree(p.params), np_tree(p.batch_stats)),
        "critic": convert.flashsac_critic_state_dict(np_tree(c.params), np_tree(c.batch_stats)),
        "critic_target": convert.flashsac_critic_state_dict(np_tree(c.target_params), np_tree(c.target_batch_stats)),
        "alpha": convert.entropy_coefficient_state_dict(np_tree(states["alpha"].params)),
    }


def _assert_states(model, states, tol, when):
    trees = _jax_trees(states)
    for name, module in (("policy", model.policy.module), ("critic", model.critic.module),
                         ("critic_target", model.critic.target), ("alpha", model.alpha.module)):
        assert_state_dict(module, trees[name], tol, f"{when}: {name}")


def test_batchnorm_follows_flax():
    """Train mode normalizes with the batch's biased statistics and returns
    ``0.99 * running + 0.01 * batch``; eval mode uses the running ones."""
    import flax.linen as nn
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x = (3.0 * rng.normal(size=(64, 12)) + 1.5).astype(np.float32)
    bn = nn.BatchNorm(momentum=0.99)
    params = {"scale": rng.normal(size=12).astype(np.float32), "bias": rng.normal(size=12).astype(np.float32)}
    stats = {"mean": rng.normal(size=12).astype(np.float32), "var": rng.uniform(0.5, 2, size=12).astype(np.float32)}
    variables = {"params": params, "batch_stats": stats}
    ref_train, mutated = bn.apply(variables, jnp.asarray(x), use_running_average=False, mutable=["batch_stats"])
    ref_eval = bn.apply(variables, jnp.asarray(x), use_running_average=True)
    ours = layers.BatchNorm(12)
    ours.load_state_dict({k[len("n."):]: v for k, v in convert._norm_with_stats("n", params, stats).items()})
    close(ours(torch.tensor(x), False), ref_eval, 1e-5, "eval")
    close(ours(torch.tensor(x), True), ref_train, 1e-5, "train")
    ours.commit()
    close(ours.mean, mutated["batch_stats"]["mean"], 1e-6, "running mean")
    close(ours.var, mutated["batch_stats"]["var"], 1e-6, "running var")
    # torch's BatchNorm1d would feed the unbiased variance
    assert not np.allclose(ours.var.numpy(), 0.99 * stats["var"] + 0.01 * x.var(0, ddof=1), atol=1e-6)


def test_project_params_matches_jax():
    """Random (unprojected) parameters of both nets: unit kernels per output
    unit, RMSNorm scale at sqrt(d), BatchNorm (scale, bias) jointly at
    sqrt(d), biases as they were."""
    import jax

    from rlx_tpu.algorithms.flashsac.tpu.layers import FlashSACDoubleCritic, FlashSACPolicy
    from rlx_tpu.algorithms.flashsac.tpu.layers import project_params as jax_project

    rng = np.random.default_rng(1)
    obs, action = np.zeros((2, 5), np.float32), np.zeros((2, 2), np.float32)
    nets = [
        (FlashSACPolicy(2, 8, 1), (obs, False), layers.FlashSACPolicy(5, 2, 8, 1), convert.flashsac_policy_state_dict),
        (FlashSACDoubleCritic(8, 2, ATOMS, -5.0, 5.0), (obs, action, False),
         layers.FlashSACDoubleCritic(5, 2, 8, 2, ATOMS, -5.0, 5.0), convert.flashsac_critic_state_dict),
    ]
    for flax_module, inputs, module, to_port in nets:
        variables = flax_module.init(jax.random.PRNGKey(0), *inputs)
        params = jax.tree.map(lambda x: x * rng.uniform(0.2, 3.0, size=x.shape).astype(np.float32),
                              variables["params"])
        stats = np_tree(variables["batch_stats"])
        module.load_state_dict(to_port(np_tree(params), stats))
        layers.project_params(module)
        assert_state_dict(module, to_port(np_tree(jax_project(params)), stats), 1e-6, type(module).__name__)


def test_two_updates_match_jax():
    import jax
    import jax.numpy as jnp

    jmodel, model = models("flashsac", SMALL, "locomotion.ant")
    rng = np.random.default_rng(2)
    states = dict(jmodel.states)
    states["reward_normalizer"] = {**states["reward_normalizer"], "var": jnp.asarray(4.0), "g_max": jnp.asarray(30.0)}
    # the JAX checkpoint tree of these states (BatchNorm statistics, noise
    # and reward normalizer included), carried into the port
    model.restore_from_tree(convert.checkpoint_tree_from_jax("flashsac", np_tree(jmodel.checkpoint_tree(states))))
    _assert_states(model, states, 0.0, "carried")
    obs = rng.normal(size=(B, OBS)).astype(np.float32)
    close(model.eval_act(torch.tensor(obs)), jmodel.eval_act(states, obs), 1e-5, "eval_act")
    assert all(torch.equal(model.noise[k], torch.tensor(np.asarray(states["noise"][k]))) for k in model.noise)
    jupdate = jax.jit(jmodel.update)
    for step in (0, 1):
        data = batch(rng, B, OBS, ACT, scale=2.0)
        data["reward"] *= 5.0
        key = jax.random.PRNGKey(30 + step)
        states, jmetrics = jupdate(states, data, key, step)
        policy_key, critic_key = jax.random.split(key)
        metrics = model.update(to_torch(data), step, policy_noise=normals(policy_key, (B, ACT)),
                               target_noise=normals(critic_key, (B, ACT)))
        assert set(metrics) == set(jmetrics)
        for k in jmetrics:
            close(float(metrics[k]), float(jmetrics[k]), 1e-5, f"step {step}: {k}")
        _assert_states(model, states, 1e-5, f"after step {step}")
    # delay 2: the policy and log_alpha stepped once, the critic twice
    assert model.policy.step_count() == model.alpha.step_count() == int(states["policy"].opt_state.count) == 1
    assert model.critic.step_count() == int(states["critic"].opt_state.count) == 2


def test_polyak_averages_the_unprojected_critic():
    """The JAX package's order, which the port keeps: the target moves
    towards the critic's parameters as Adam left them, and only then is the
    online critic projected.  RL-X (``flashsac/flax/flashsac.py``) projects
    first and averages the projected parameters: a deliberate deviation of
    the JAX package that the port follows, since it is held against it."""
    from rlx_tpu_torch.config import create_model, make_config

    # a large step and tau, so the unprojected norms stand clear of 1
    fast = {f"algorithm.learning_rate_{k}": 0.05 for k in ("init", "peak", "end")}
    model = create_model(make_config("flashsac.cuda", "classic.pendulum.cuda", **SMALL, **fast, **{
        "algorithm.tau": 0.5, "runner.device": "cpu"}))
    rng = np.random.default_rng(3)
    before = {k: v.clone() for k, v in model.critic.target.named_parameters()}
    model.update(to_torch(batch(rng, B, 3, 1)), 0)
    tau = model.tau
    online = dict(model.critic.module.named_parameters())
    unprojected = layers.FlashSACDoubleCritic(3, 1, 16, 2, ATOMS, -5.0, 5.0)
    with torch.no_grad():
        for name, p in unprojected.named_parameters():
            p.copy_((dict(model.critic.target.named_parameters())[name] - (1.0 - tau) * before[name]) / tau)
    kernels = [n for n in online if n.endswith("linear1.weight") or n == "head.weight"]
    # the averaged parameters were not yet on the unit sphere ...
    assert any(not torch.allclose(torch.linalg.vector_norm(dict(unprojected.named_parameters())[n], dim=-1),
                                  torch.ones(()), atol=1e-3) for n in kernels)
    # ... and projecting them gives the online critic
    layers.project_params(unprojected)
    for name, p in unprojected.named_parameters():
        torch.testing.assert_close(p, online[name], rtol=1e-4, atol=1e-5)


def test_repeated_noise_and_schedule_match_jax():
    import jax
    import optax

    jmodel, model = models("flashsac", SMALL)
    states = jmodel.states
    model.noise = to_torch(states["noise"])
    for step in range(40):
        key = jax.random.PRNGKey(100 + step)
        states = jmodel.pre_act(states, key, step)
        noise_key, n_key = jax.random.split(key)
        model.pre_act(step, fresh_noise=normals(noise_key, (8, 1)),
                      uniform=torch.tensor(float(jax.random.uniform(n_key, ()))))
        for k in ("noise", "count", "n"):
            np.testing.assert_array_equal(model.noise[k].numpy(), np.asarray(states["noise"][k]), err_msg=f"{step} {k}")
    assert int(states["noise"]["n"]) > 1 or int(states["noise"]["count"]) > 0
    for warmup in (0, 5):
        model.schedule = (1e-4, 3e-4, 1.5e-4, warmup, 50)
        reference = optax.warmup_cosine_decay_schedule(1e-4, 3e-4, warmup, 50, 1.5e-4)
        for count in (0, 1, 3, 5, 17, 49, 50, 80):
            assert model.learning_rate_at(count) == pytest.approx(float(reference(count)), rel=1e-6)


def test_runner_round_trip_carries_the_batch_statistics(tmp_path, monkeypatch):
    """Train through the Runner with the optimizers' state, then test mode
    from ``latest.model``: parameters, the three BatchNorm streams, the
    noise and reward-normalizer states, Adam moments and the update count
    equal bit for bit; the running statistics moved off their init."""
    monkeypatch.chdir(tmp_path)
    args = ["--algorithm.name=flashsac.cuda", "--environment.name=classic.pendulum.cuda", "--runner.device=cpu",
            *(f"--{k}={v}" for k, v in SMALL.items()), "--environment.nr_envs=4",
            "--algorithm.total_timesteps=128", "--algorithm.logging_frequency=32",
            "--runner.save_optimizer_state=True"]
    trained = Runner([*args, "--runner.save_model=True", "--runner.run_name=train"]).run()
    assert trained.nr_updates == 16 and trained.policy.step_count() == 8
    latest = tmp_path / "runs" / "rlx_tpu_torch" / "default" / "train" / "models" / "latest.model"
    tester = Runner([*args, "--runner.mode=test", f"--runner.load_model={latest}", "--runner.nr_test_episodes=2",
                     "--runner.run_name=test"])
    returns = tester.run()
    assert len(returns) == 2 and all(np.isfinite(returns))
    tree = trained.checkpoint_tree()["full"]
    assert set(tree) == {"policy", "critic", "alpha", "noise", "reward_normalizer", "nr_updates"}
    assert "trunk.embedder.norm.mean" in tree["critic"]["target_params"]
    assert same_tree(trained.checkpoint_tree(), tester.model.checkpoint_tree()) > 0
    for module in (trained.policy.module, trained.critic.module, trained.critic.target):
        assert not torch.equal(module.trunk.embedder.norm.var, torch.ones_like(module.trunk.embedder.norm.var))
