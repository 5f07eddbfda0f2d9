"""The port's FastMPO against the JAX package's, and the off-policy core's
two FastMPO pieces:

- ``update_with_buffer`` over two env steps (a policy update after 2
  critic updates each) at the FastSAC network shapes, from a JAX checkpoint tree
  carried in by ``convert.checkpoint_tree_from_jax``, the sample and the
  normals JAX draws injected, in float64 on both sides (1e-5);
- the action pipeline: ``action_clipping`` x ``action_rescaling`` in its
  three modes, and the default of a config without the keys, against the
  JAX core on the same config and box (1e-6);
- the per-env sizing keys ``learning_starts_per_env`` /
  ``buffer_size_per_env`` against the JAX core's sizing;
- BRO, MPO and FastMPO through ``train()`` on Pendulum on the CPU.
"""

import numpy as np
import pytest
import torch

from rlx_tpu_torch import convert
from rlx_tpu_torch.config import create_env, create_model, make_config
from torch_parity import assert_tree_close, batch, close, models, normals, np_tree, to_torch
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)


def _carried(algorithm, jmodel, states):
    return convert.checkpoint_tree_from_jax(algorithm, np_tree(jmodel.checkpoint_tree(states)))


FASTMPO = {"environment.nr_envs": 4, "algorithm.batch_size": 8, "algorithm.action_sampling_number": 3,
           "algorithm.nr_atoms": 11, "algorithm.nr_critic_updates_per_policy_update": 2,
           "algorithm.nr_policy_updates_per_step": 1, "algorithm.action_penalization": True,
           "algorithm.clipped_double_q_learning": True}


def test_fastmpo_update_with_buffer_matches_jax(monkeypatch):
    """At the FastSAC network shapes (SiLU, a LayerNorm after every Dense,
    zero-init heads, the scaled std head), twin critics with clipped double
    Q and the action penalty on: one sample of 2 x 8 cut into per-update
    slices, the normalizer updated from its states and next states, the
    policy step on the last critic step's slice with that step's second
    key.  In float64 on both sides, the sample injected into JAX's sampler:
    AdamW with b2 0.95 turns f32 rounding into steps of up to twice the
    learning rate on the weights whose gradient is near zero (5e-4 on the
    policy after one env step in f32, in either package), while in float64
    every value agrees far inside 1e-5."""
    import jax
    import jax.numpy as jnp

    from rlx_tpu.ops import replay_buffer as jrb

    jmodel, model = models("fastmpo", FASTMPO)
    states = jmodel.states
    rng = np.random.default_rng(7)
    # move the zero heads off zero, so the policy's outputs and gradients are generic
    states["policy"] = states["policy"].replace(params=jax.tree.map(
        lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32), states["policy"].params))
    states["policy"] = states["policy"].replace(target_params=states["policy"].params)
    model.restore_from_tree(_carried("fastmpo", jmodel, states))
    obs = rng.normal(size=(4, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    close(model.act(torch.tensor(obs), noise=normals(key, (4, 1))), jmodel.act(states, obs, key, 0), 1e-6, "act")

    sample = {}
    monkeypatch.setattr(jrb, "sample", lambda *args, **kwargs: sample["batch"])

    def jax_update(states, data, key):
        sample["batch"] = data
        return jmodel.update_with_buffer(states, None, key, 0)

    n_up = 2
    with jax.enable_x64(True):
        states = jax.tree.map(lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a,
                              states)
        for module in (model.policy.module, model.policy.target, model.critic.module, model.critic.target,
                       model.duals.module):
            module.double()
        model.obs_normalizer = {k: v.double() for k, v in model.obs_normalizer.items()}
        jupdate = jax.jit(jax_update)
        for step in (0, 1):
            data = {k: v.astype(np.float64) for k, v in batch(rng, n_up * 8, 3, 1, scale=2.0).items()}
            data["action"] *= 1.5
            key = jax.random.PRNGKey(90 + step)
            states, jmetrics = jupdate(states, data, key)
            _, update_key = jax.random.split(key)
            keys = jax.random.split(update_key, 2 * n_up).reshape(n_up, 2, 2)
            metrics = model.update_with_buffer(
                None, step, batch=to_torch(data), critic_noises=[normals(keys[i, 0], (3, 8, 1)) for i in range(n_up)],
                policy_noises=[normals(keys[i, 1], (3, 16, 1)) for i in range(n_up)])
            assert set(metrics) == set(jmetrics)
            for k in jmetrics:
                close(float(metrics[k]), float(jmetrics[k]), 1e-5, f"step {step}: {k}")
            assert_tree_close(model.checkpoint_tree(), _carried("fastmpo", jmodel, states), 1e-5, f"after step {step}")
    assert model.critic.step_count() == 4 and model.policy.step_count() == 2


def _bare_cores(algorithm, overrides, low, high, center, scale):
    """The JAX and the port's off-policy core built from one config with no
    networks, on a Pendulum whose action space is replaced by a 3-d box."""
    from rlx_tpu.algorithms.offpolicy import OffPolicyAlgorithm as JaxCore
    from rlx_tpu.config import create_env as jax_create_env
    from rlx_tpu.config import make_config as jax_make_config
    from rlx_tpu.environments.spaces import BoxSpace as JaxBox
    from rlx_tpu_torch.algorithms.offpolicy import OffPolicyAlgorithm
    from rlx_tpu_torch.environments.spaces import BoxSpace

    class JaxBare(JaxCore):
        def setup_states(self):
            return {}

    class Bare(OffPolicyAlgorithm):
        def setup_states(self):
            pass

    jconfig = jax_make_config(f"{algorithm}.tpu", "classic.pendulum.tpu", **overrides, **{"runner.mesh_dp": 1})
    config = make_config(f"{algorithm}.cuda", "classic.pendulum.cuda", **overrides, **{"runner.device": "cpu"})
    jenv, env = jax_create_env(jconfig)[0], create_env(config)[0]
    jenv.single_action_space = JaxBox(low, high, (3,), center=center, scale=scale)
    env.single_action_space = BoxSpace(low, high, (3,), center=center, scale=scale)
    return JaxBare(jconfig, jenv, jenv, None, None), Bare(config, env, env)


BOX = (np.array([-2.0, -1.0, 0.0], np.float32), np.array([2.0, 3.0, 0.5], np.float32),
       np.array([0.0, 0.5, 0.1], np.float32), np.array([1.0, 2.0, 0.25], np.float32))


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("rescaling", ["none", "normal", "fastsac", None])
def test_action_pipeline_matches_jax(rescaling, clip):
    """FastMPO's ``action_clipping`` x ``action_rescaling`` (``None``: SAC's
    config, which has neither key and always clips and rescales) on a box
    with a center and a scale, actions inside and outside [-1, 1]."""
    if rescaling is None:
        algorithm, overrides = "sac", {}
    else:
        algorithm, overrides = "fastmpo", {"algorithm.action_clipping": clip, "algorithm.action_rescaling": rescaling}
    jcore, core = _bare_cores(algorithm, overrides, *BOX)
    action = (2.0 * np.random.default_rng(1).normal(size=(64, 3))).astype(np.float32)
    close(core.process_action(torch.tensor(action)), jcore.process_action(action), 1e-6, f"{rescaling} {clip}")
    if rescaling == "none" and not clip:
        assert torch.equal(core.process_action(torch.tensor(action)), torch.tensor(action))


@pytest.mark.parametrize("per_env", [(3, 50), (0, 0)])
def test_per_env_sizing_matches_jax(per_env):
    """``learning_starts_per_env`` / ``buffer_size_per_env`` when positive,
    else ``learning_starts`` and the buffer_size-derived capacity."""
    learning_starts_per_env, buffer_size_per_env = per_env
    overrides = {"environment.nr_envs": 4, "algorithm.learning_starts": 40, "algorithm.total_timesteps": 400,
                 "algorithm.learning_starts_per_env": learning_starts_per_env,
                 "algorithm.buffer_size_per_env": buffer_size_per_env, "algorithm.logging_frequency": 40}
    jcore, core = _bare_cores("fastmpo", overrides, *BOX)
    for attribute in ("learning_starts", "capacity", "prefill_iterations", "total_training_timesteps",
                      "nr_eval_save_iterations", "nr_updates_per_logging_iteration"):
        assert getattr(core, attribute) == getattr(jcore, attribute), attribute
    assert (core.learning_starts, core.capacity) == ((12, 50) if learning_starts_per_env else (40, 1))




@pytest.mark.parametrize("algorithm", ["bro", "mpo", "fastmpo"])
def test_trains_on_pendulum(algorithm):
    overrides = {"runner.device": "cpu", "environment.nr_envs": 4, "algorithm.batch_size": 8,
                 "algorithm.logging_frequency": 16, "algorithm.evaluation_active": False}
    if algorithm == "fastmpo":
        overrides.update({"algorithm.learning_starts_per_env": 4, "algorithm.total_timesteps": 48,
                          "algorithm.nr_policy_updates_per_step": 1, "algorithm.action_sampling_number": 2,
                          "algorithm.policy_network_type": "mpo", "algorithm.critic_network_type": "mpo",
                          "algorithm.policy_hidden_sizes": (8, 8), "algorithm.critic_hidden_sizes": (8, 8)})
    else:
        overrides.update({"algorithm.learning_starts": 16, "algorithm.total_timesteps": 48,
                          "algorithm.buffer_size": 256})
    if algorithm == "bro":
        overrides.update({"algorithm.updates_per_step": 2, "algorithm.policy_hidden_dim": 8,
                          "algorithm.critic_hidden_dim": 8, "algorithm.nr_quantiles": 5,
                          "algorithm.first_reset_step": 8, "algorithm.reset_interval": 16})
    if algorithm == "mpo":
        overrides.update({"algorithm.policy_hidden_sizes": (8, 8), "algorithm.critic_hidden_sizes": (8, 8),
                          "algorithm.action_sampling_number": 2})
    model = create_model(make_config(f"{algorithm}.cuda", "classic.pendulum.cuda", **overrides))
    model.train()
    assert [m["steps/nr_updates"] for m in model.metrics_history] == [4, 8]
    assert model.prefill_iterations == 4 and model.nr_updates == 8
    assert all(np.isfinite(v) for m in model.metrics_history for v in m.values())
    if algorithm == "bro":
        # resets at learning steps 2 and 6 (8 // 4, then every 16 // 4)
        assert [m["bro/reset"] for m in model.metrics_history] == [0.25, 0.25]
