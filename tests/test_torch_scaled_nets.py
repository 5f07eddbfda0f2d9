"""The port's scaled networks (``models/layers.py``, ``models/weight_norm.py``)
and SimBa, XQC, SimbaV2 and CrossQ against the JAX package's:

- every layer of ``models/layers.py`` on converted flax parameters, and
  ``BatchRenorm`` in train mode before and after its 1000-step warmup and
  in eval mode, with the statistics it returns;
- ``weight_norm_`` against ``weight_norm_params`` on XQC's and SimbaV2's
  nets;
- two ``update`` calls of each algorithm from a JAX checkpoint tree carried
  in by ``convert.checkpoint_tree_from_jax`` (parameters, targets, running
  statistics, normalizers), with JAX's normals replayed: ``eval_act``
  before, then every metric, parameter, target, statistic and
  ``log_alpha`` after each call (1e-5); XQC at policy delay 2 (the second
  step skips the policy), CrossQ across the renorm warmup;
- the ten new algorithms' defaults against the JAX package's;
- a ``Runner`` save -> load -> test round trip that carries CrossQ's
  renorm statistics and step counts bit for bit.
"""

import numpy as np
import pytest
import torch

from rlx_tpu_torch import convert
from rlx_tpu_torch.config import make_config
from rlx_tpu_torch.models import layers
from rlx_tpu_torch.runner.runner import Runner
from torch_parity import assert_state_dict, batch, close, models, normals, np_tree, same_tree, to_torch
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

B = 16
NEW = ("fastsac", "flashsac", "redq", "droq", "aqe", "tqc", "simba", "xqc", "simbav2", "crossq")


def _init(module, *args, **kwargs):
    import jax

    return np_tree(module.init(jax.random.PRNGKey(0), *args, **kwargs))


def _strip(tree, prefix):
    return {k[len(prefix) + 1:]: v for k, v in tree.items()}


def test_layers_match_flax():
    """SimBa, BroNet and SimbaV2 encoders and the hypersphere head on
    random inputs: the converted parameters give flax's outputs (1e-5)."""
    import jax
    import jax.numpy as jnp

    from rlx_tpu.models import layers as jl

    rng = np.random.default_rng(0)
    x = (2.0 * rng.normal(size=(32, 7))).astype(np.float32)
    h = (rng.normal(size=(32, 12))).astype(np.float32)
    perturb = lambda tree: jax.tree.map(lambda a: a * rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32), tree)
    cases = [
        (jl.SimbaEncoder(12, 2), layers.SimbaEncoder(7, 12, 2), x, lambda p: convert._simba_encoder("m", p)),
        (jl.BroNetEncoder(12, 2), layers.BroNetEncoder(7, 12, 2), x, lambda p: convert._bronet("m", p)),
        (jl.SimbaV2Encoder(12, 2), layers.SimbaV2Encoder(7, 12, 2), x, lambda p: convert._simbav2_encoder("m", p)),
        (jl.HyperHead(12, 5), layers.HyperHead(12, 5), h, lambda p: convert._hyper_head("m", p)),
    ]
    for flax_module, module, inputs, to_port in cases:
        params = perturb(_init(flax_module, inputs)["params"])
        module.load_state_dict(_strip(to_port(params), "m"))
        ref = flax_module.apply({"params": params}, jnp.asarray(inputs))
        close(module(torch.tensor(inputs)), ref, 1e-5, type(module).__name__)
    close(layers.l2_normalize(torch.tensor(x)), jl.l2_normalize(jnp.asarray(x)), 1e-6, "l2_normalize")


@pytest.mark.parametrize("steps", [5, 1500])
def test_batch_renorm_matches_flax(steps):
    """Plain BN (r = 1, d = 0) up to step 1000, renormalized after; the
    gradient through the batch statistics but not through r and d; the
    running statistics and the step count it returns; eval mode."""
    import jax
    import jax.numpy as jnp

    from rlx_tpu.models.layers import BatchRenorm as JaxBatchRenorm

    rng = np.random.default_rng(steps)
    x = (3.0 * rng.normal(size=(64, 6)) + 2.0).astype(np.float32)
    variables = {
        "params": {"scale": rng.uniform(0.5, 2, size=6).astype(np.float32), "bias": rng.normal(size=6).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(size=6).astype(np.float32), "var": rng.uniform(0.1, 3, size=6).astype(np.float32),
                        "steps": np.asarray(steps, np.int32)},
    }
    flax_module = JaxBatchRenorm()
    ours = layers.BatchRenorm(6)
    ours.load_state_dict(_strip(convert._norm_with_stats("n", variables["params"], variables["batch_stats"]), "n"))
    weights = rng.normal(size=(64, 6)).astype(np.float32)

    def jax_loss(inputs):
        out, mutated = flax_module.apply(variables, inputs, use_running_average=False, mutable=["batch_stats"])
        return (out * weights).sum(), (out, mutated)

    (_, (ref, mutated)), ref_grad = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(x))
    inputs = torch.tensor(x, requires_grad=True)
    out = ours(inputs, True)
    (grad,) = torch.autograd.grad((out * torch.tensor(weights)).sum(), inputs)
    close(out, ref, 1e-5, "train")
    close(grad, ref_grad, 1e-5, "input gradient")
    close(ours(torch.tensor(x), False), flax_module.apply(variables, jnp.asarray(x), use_running_average=True),
          1e-5, "eval")
    ours.commit()
    for name in ("mean", "var"):
        close(getattr(ours, name), mutated["batch_stats"][name], 1e-6, name)
    assert int(ours.steps) == int(mutated["batch_stats"]["steps"]) == steps + 1


def test_weight_norm_matches_jax():
    """XQC's and SimbaV2's nets with random (unnormalized) parameters: the
    port's ``weight_norm_`` on its explicit layer lists against
    ``weight_norm_params`` on flax's auto-names, with and without the heads."""
    import jax

    from rlx_tpu.algorithms.simbav2.tpu.simbav2 import SimbaV2Policy, SimbaV2VectorCritic
    from rlx_tpu.algorithms.xqc.tpu.xqc import XQCPolicy, XQCVectorCritic
    from rlx_tpu.models.weight_norm import weight_norm_params
    from rlx_tpu_torch.algorithms.simbav2.cuda import simbav2
    from rlx_tpu_torch.algorithms.xqc.cuda import xqc
    from rlx_tpu_torch.models.weight_norm import weight_norm_

    rng = np.random.default_rng(1)
    obs, action = np.zeros((2, 3), np.float32), np.zeros((2, 1), np.float32)
    nets = [
        (XQCPolicy(1, 8, 1), xqc.XQCPolicy(3, 1, 8, 1), (obs,), convert.simba_policy_state_dict),
        (XQCVectorCritic(8, 1, 5), xqc.XQCVectorCritic(3, 1, 8, 1, 5), (obs, action), convert.simba_critic_state_dict),
        (SimbaV2Policy(1, 8, 1), simbav2.SimbaV2Policy(3, 1, 8, 1), (obs,), convert.simbav2_policy_state_dict),
        (SimbaV2VectorCritic(8, 1, 5), simbav2.SimbaV2VectorCritic(3, 1, 8, 1, 5), (obs, action),
         convert.simbav2_critic_state_dict),
    ]
    for flax_module, module, inputs, to_port in nets:
        for normalize_last_layer in (True, False):
            params = jax.tree.map(lambda a: a * rng.uniform(0.3, 3.0, size=a.shape).astype(np.float32),
                                  _init(flax_module, *inputs)["params"])
            module.load_state_dict(to_port(params))
            weight_norm_(module.hidden_layers(), module.predictor_layers(), normalize_last_layer)
            ref = to_port(np_tree(weight_norm_params(params, normalize_last_layer=normalize_last_layer)))
            assert_state_dict(module, ref, 1e-6, f"{type(module).__name__} {normalize_last_layer}")


SCALED = {
    "simba": {"algorithm.policy_hidden_dim": 8, "algorithm.critic_hidden_dim": 16},
    "xqc": {"algorithm.policy_hidden_dim": 8, "algorithm.critic_hidden_dim": 16, "algorithm.policy_nr_blocks": 1,
            "algorithm.critic_nr_blocks": 2, "algorithm.nr_atoms": 11, "algorithm.policy_delay": 2},
    "simbav2": {"algorithm.policy_hidden_dim": 8, "algorithm.critic_hidden_dim": 16, "algorithm.nr_atoms": 11},
    "crossq": {"algorithm.policy_hidden_sizes": (16, 8), "algorithm.critic_hidden_sizes": (32, 32),
               "algorithm.policy_delay": 2},
}


def _converters(algorithm):
    """(policy, critic) converters taking a JAX state."""
    if algorithm == "crossq":
        return (lambda s: convert.squashed_gaussian_policy_state_dict(np_tree(s.params)),
                lambda s, field="params": convert.crossq_critic_state_dict(np_tree(s.params), np_tree(s.batch_stats)))
    policy, critic = ((convert.simbav2_policy_state_dict, convert.simbav2_critic_state_dict) if algorithm == "simbav2"
                      else (convert.simba_policy_state_dict, convert.simba_critic_state_dict))
    return (lambda s: policy(np_tree(s.params)),
            lambda s, field="params": critic(np_tree(getattr(s, field))))


def _assert_states(algorithm, model, states, tol, when):
    to_policy, to_critic = _converters(algorithm)
    assert_state_dict(model.policy.module, to_policy(states["policy"]), tol, f"{when}: policy")
    assert_state_dict(model.critic.module, to_critic(states["critic"]), tol, f"{when}: critic")
    if model.critic.target is not None:
        assert_state_dict(model.critic.target, to_critic(states["critic"], "target_params"), tol, f"{when}: target")
    assert_state_dict(model.alpha.module, convert.entropy_coefficient_state_dict(np_tree(states["alpha"].params)),
                      tol, f"{when}: log_alpha")


@pytest.mark.parametrize("algorithm", sorted(SCALED))
def test_two_updates_match_jax(algorithm):
    """SimBa and CrossQ run in float64 on both sides.  CrossQ: a bias just
    before a train-mode BatchRenorm (the input's norm, each hidden Dense)
    shifts every sample alike, which the batch mean removes, so its gradient
    is zero but for rounding, and Adam turns f32 rounding into steps of up
    to the learning rate in either package; in f64 those steps are ~1e-10
    of it.  SimBa: its log-std spans [-20, 2] through a tanh, which
    magnifies f32 rounding 11-fold; in f32 the policy's gradient norm
    differs by 4e-5 relative, in f64 every value agrees at 1e-5."""
    import contextlib

    import jax

    f64 = algorithm in ("crossq", "simba")
    with jax.enable_x64(True) if f64 else contextlib.nullcontext():
        _two_updates(algorithm, jax.numpy.float64 if f64 else jax.numpy.float32)


def _two_updates(algorithm, dtype):
    import jax
    import jax.numpy as jnp

    jmodel, model = models(algorithm, {"environment.nr_envs": 8, "algorithm.batch_size": B,
                                       "algorithm.evaluation_active": False, **SCALED[algorithm]}, "locomotion.ant")
    states = dict(jmodel.states)
    rng = np.random.default_rng(len(algorithm))
    if algorithm == "simbav2":
        states["obs_normalizer"] = {"mean": jnp.asarray(rng.normal(size=34), jnp.float32),
                                    "var": jnp.asarray(rng.uniform(0.5, 4, size=34), jnp.float32),
                                    "count": jnp.asarray(50.0)}
        states["reward_normalizer"] = {**states["reward_normalizer"], "var": jnp.asarray(3.0), "g_max": jnp.asarray(40.0)}
    if algorithm == "crossq":
        # the first update normalizes plainly (steps 1000), the second renormalizes
        stats = jax.tree.map(lambda a: jnp.full_like(a, 1000) if a.dtype == jnp.int32 else a, states["critic"].batch_stats)
        states["critic"] = states["critic"].replace(batch_stats=stats)
    # the JAX checkpoint tree of these states, carried into the port
    model.restore_from_tree(convert.checkpoint_tree_from_jax(algorithm, np_tree(jmodel.checkpoint_tree(states))))
    _assert_states(algorithm, model, states, 0.0, "carried")
    obs = rng.normal(size=(B, 34)).astype(np.float32)
    close(model.eval_act(torch.tensor(obs)), jmodel.eval_act(states, obs), 1e-5, "eval_act")
    if dtype == jnp.float64:
        states = jax.tree.map(lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a, states)
        for module in (model.policy.module, model.critic.module, model.critic.target, model.alpha.module):
            if module is not None:
                module.double()
    jupdate = jax.jit(jmodel.update)
    for step in (0, 1):
        data = batch(rng, B, 34, 8, scale=2.0)
        data["reward"] *= 3.0
        data = {k: v.astype(dtype) for k, v in data.items()}
        key = jax.random.PRNGKey(60 + step)
        states, jmetrics = jupdate(states, data, key, step)
        target_key, current_key = jax.random.split(key)
        metrics = model.update(to_torch(data), step, target_noise=normals(target_key, (B, 8)),
                               current_noise=normals(current_key, (B, 8)))
        assert set(metrics) == set(jmetrics)
        for k in jmetrics:
            close(float(metrics[k]), float(jmetrics[k]), 1e-5, f"{algorithm} step {step}: {k}")
        _assert_states(algorithm, model, states, 1e-5, f"{algorithm} after step {step}")
    delayed = algorithm in ("xqc", "crossq")
    assert model.policy.step_count() == int(states["policy"].opt_state.count) == (1 if delayed else 2)
    if algorithm == "crossq":
        assert model.critic.module.norms[0].steps.tolist() == [1002, 1002]


def test_defaults_match_jax():
    """Every key and value of the JAX package's defaults but the mesh's
    ``shard_local_sampling``."""
    import importlib

    for algorithm in NEW:
        jax_config = importlib.import_module(f"rlx_tpu.algorithms.{algorithm}.tpu.default_config")
        ref = jax_config.get_config(f"{algorithm}.tpu").to_dict()
        ref = {k: v for k, v in ref.items() if k not in ("shard_local_sampling", "name")}
        ours = dict(make_config(f"{algorithm}.cuda", "classic.pendulum.cuda").algorithm)
        assert ours.pop("name") == f"{algorithm}.cuda"
        assert ours == ref, algorithm


def test_crossq_runner_round_trip_carries_the_renorm_state(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ["--algorithm.name=crossq.cuda", "--environment.name=classic.pendulum.cuda", "--runner.device=cpu",
            "--environment.nr_envs=4", "--algorithm.batch_size=16", "--algorithm.critic_hidden_sizes=(32, 32)",
            "--algorithm.policy_hidden_sizes=(16, 16)", "--algorithm.learning_starts=64",
            "--algorithm.total_timesteps=128", "--algorithm.logging_frequency=32",
            "--algorithm.evaluation_active=False", "--runner.save_optimizer_state=True"]
    trained = Runner([*args, "--runner.save_model=True", "--runner.run_name=train"]).run()
    assert trained.nr_updates == 16 and trained.policy.step_count() == 6
    latest = tmp_path / "runs" / "rlx_tpu_torch" / "default" / "train" / "models" / "latest.model"
    returns = (tester := Runner([*args, "--runner.mode=test", f"--runner.load_model={latest}",
                                 "--runner.nr_test_episodes=2", "--runner.run_name=test"])).run()
    assert len(returns) == 2 and all(np.isfinite(returns))
    tree = trained.checkpoint_tree()["full"]
    assert set(tree) == {"policy", "critic", "alpha", "nr_updates"} and "target_params" not in tree["critic"]
    assert tree["critic"]["params"]["norms.0.steps"].tolist() == [17, 17]
    assert same_tree(trained.checkpoint_tree(), tester.model.checkpoint_tree()) > 0
