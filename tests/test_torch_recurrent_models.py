"""The port's recurrent policy (``rlx_tpu_torch/models/recurrent.py``)
against the JAX package's, from converted parameters, at small widths
(obs encoding 8, hidden 4, context 4, 2 heads, state 4, conv 3; the torso
is fixed at 512/256/128), with the init's parameters perturbed so that the
carry's share of the means is far above the tolerance, in f32 at 1e-5:

- ``one_step`` over 6 steps from a warm carry (a streaming prefix with a
  done inside), the carry masked after the dones: means, logstd and every
  leaf of the carry at every step;
- ``sequence`` over a 7-step window with dones inside, from the same warm
  carry, against JAX's ``sequence`` and against the port's own
  ``one_step`` scan (the transformer's parallel path, the Mamba-2
  parallel conv);
- each cell with ``concat`` and with ``film`` + a shared encoder +
  ``observation_indices``;
- ``mask_carry`` on every carry type.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlx_tpu.models import recurrent as jax_recurrent
from rlx_tpu_torch import convert
from rlx_tpu_torch.models import recurrent
from torch_parity import close, np_tree
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

OBS, ACTIONS, B, WARM, T = 5, 2, 3, 5, 7
TOL = 1e-5
SMALL = dict(obs_encoding_dim=8, hidden_dim=4, cell_context_len=4, cell_nr_heads=2, cell_state_dim=4,
             cell_conv_kernel=3)
VARIANTS = {"concat": dict(combine_method="concat"),
            "film, shared encoder, indices": dict(combine_method="film", share_encoder=True,
                                                  observation_indices=(4, 0, 2))}


def to_torch(carry):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), carry)


def leaves(carry):
    return jax.tree.leaves(carry)


def perturbed(params):
    """The init plus noise (less on the mean head, whose means stay O(1)),
    and Mamba-2's dt near 1: at the init the mean head's gain of 0.01 and dt
    in [1e-3, 0.1] leave the SSM state's share of the means below the
    tolerance."""
    rng = np.random.default_rng(11)
    noise = lambda path, a: a + (0.03 if "mean_head" in jax.tree_util.keystr(path) else 0.2) * rng.normal(
        size=a.shape).astype(np.float32)
    params = jax.tree_util.tree_map_with_path(noise, params)
    inner = params["params"]["cell"]
    if "dt_bias" in inner:
        inner["dt_bias"] = jnp.full_like(inner["dt_bias"], 0.5)
    return params


def policies(cell, variant, nr_blocks=2, perturb=True):
    kwargs = {**SMALL, **VARIANTS[variant], "cell_nr_blocks": nr_blocks}
    jpolicy = jax_recurrent.RecurrentPolicy(action_dim=ACTIONS, cell_type=cell, **kwargs)
    params = jpolicy.init(jax.random.PRNGKey(1), jnp.zeros((B, OBS)), jpolicy.initialize_carry(B),
                          method=jpolicy.one_step)
    params = perturbed(params) if perturb else params
    policy = recurrent.RecurrentPolicy(OBS, ACTIONS, cell_type=cell, **kwargs)
    policy.load_state_dict(convert.recurrent_policy_state_dict(np_tree(params)))
    return jpolicy, params, policy


def warm_carry(jpolicy, params):
    """A carry after a streaming prefix of WARM steps with a done at step 3
    of env 1: non-zero everywhere but env 1's (and, for the transformer,
    partly valid caches)."""
    one_step = jax.jit(lambda o, c: jpolicy.apply(params, o, c, method=jpolicy.one_step))
    rng = np.random.default_rng(7)
    carry = jpolicy.initialize_carry(B)
    for t in range(WARM):
        _, _, carry = one_step(jnp.asarray(rng.normal(size=(B, OBS)), jnp.float32), carry)
        carry = jax_recurrent.mask_carry(carry, jnp.asarray([0.0, float(t == 3), 0.0]))
    return carry


def window(seed=3):
    rng = np.random.default_rng(seed)
    obs = (1.5 * rng.normal(size=(T, B, OBS))).astype(np.float32)
    dones = np.zeros((T, B), np.float32)
    dones[2, 0] = dones[4, 2] = dones[5, 2] = dones[0, 1] = 1.0
    return obs, dones


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("cell", ["lstm", "gru", "mamba2", "transformer"])
def test_one_step_and_sequence_match_jax(cell, variant):
    jpolicy, params, policy = policies(cell, variant)
    jcarry0 = warm_carry(jpolicy, params)
    obs, dones = window()
    one_step = jax.jit(lambda o, c: jpolicy.apply(params, o, c, method=jpolicy.one_step))

    jcarry, carry = jcarry0, to_torch(jcarry0)
    means = []
    with torch.no_grad():
        for t in range(T):
            jmean, jlogstd, jcarry = one_step(obs[t], jcarry)
            mean, logstd, carry = policy.one_step(torch.tensor(obs[t]), carry)
            close(mean, jmean, TOL, f"one_step mean, t={t}")
            close(logstd, jlogstd, 0.0, "logstd")
            for ours, ref in zip(leaves(carry), leaves(jcarry)):
                close(ours, ref, TOL, f"one_step carry, t={t}")
            jcarry = jax_recurrent.mask_carry(jcarry, dones[t])
            carry = recurrent.mask_carry(carry, torch.tensor(dones[t]))
            means.append(mean)

        jmean_seq, _ = jpolicy.apply(params, obs, dones, jcarry0, method=jpolicy.sequence)
        mean_seq, logstd_seq = policy.sequence(torch.tensor(obs), torch.tensor(dones), to_torch(jcarry0))
    close(mean_seq, jmean_seq, TOL, "sequence against JAX")
    close(mean_seq, torch.stack(means), TOL, "sequence against the port's one_step scan")
    close(logstd_seq, policy.policy_logstd.detach(), 0.0, "sequence logstd")


def test_transformer_single_block_and_bool_dones():
    """One block; dones as a bool tensor (the rollout's own type)."""
    jpolicy, params, policy = policies("transformer", "concat", nr_blocks=1)
    jcarry0 = warm_carry(jpolicy, params)
    obs, dones = window(seed=4)
    jmean_seq, _ = jpolicy.apply(params, obs, dones, jcarry0, method=jpolicy.sequence)
    with torch.no_grad():
        mean_seq, _ = policy.sequence(torch.tensor(obs), torch.tensor(dones > 0), to_torch(jcarry0))
    close(mean_seq, jmean_seq, TOL, "sequence against JAX")


@pytest.mark.parametrize("cell", ["lstm", "gru", "mamba2", "transformer"])
def test_mask_carry_and_initial_carry_match_jax(cell):
    jpolicy, params, policy = policies(cell, "concat")
    jcarry = warm_carry(jpolicy, params)
    done = np.array([1.0, 0.0, 1.0], np.float32)
    ref = jax_recurrent.mask_carry(jcarry, done)
    ours = recurrent.mask_carry(to_torch(jcarry), torch.tensor(done > 0))
    assert jax.tree.structure(jax.tree.map(np.asarray, ref)) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), ours))
    for o, r in zip(leaves(ours), leaves(ref)):
        close(o, r, 0.0, "masked carry")
    initial = policy.initialize_carry(B)
    for o, r in zip(leaves(initial), leaves(jpolicy.initialize_carry(B))):
        assert tuple(o.shape) == r.shape and not o.any()


@pytest.mark.parametrize("cell", ["lstm", "gru", "mamba2", "transformer"])
def test_port_init_matches_flax_inits(cell):
    """The port's own init (used on the card) has flax's parameter shapes and
    init statistics: orthogonal recurrent kernels per gate, Mamba-2's
    ``A_log = log(1..N)``, ``D = 1``, ``dt_bias`` the inverse softplus of a
    dt in [1e-3, 0.1], the ALiBi age bias; every converted name exists."""
    jpolicy, params, _ = policies(cell, "concat", perturb=False)
    torch.manual_seed(0)
    policy = recurrent.RecurrentPolicy(OBS, ACTIONS, cell_type=cell, **SMALL, cell_nr_blocks=2)
    ref = convert.recurrent_policy_state_dict(np_tree(params))
    ours = policy.state_dict()
    assert set(ours) == set(ref)
    for key in ref:
        assert ours[key].shape == ref[key].shape, key
    if cell in ("lstm", "gru"):
        gates = 4 if cell == "lstm" else 3
        for w in ours["cell.weight_hh"].view(gates, 4, 4):
            torch.testing.assert_close(w @ w.T, torch.eye(4), rtol=1e-5, atol=1e-5)
        assert not ours["cell.bias_hh" if cell == "lstm" else "cell.bias_hn"].any()
    if cell == "mamba2":
        for key in ("cell.A_log", "cell.D", "cell.conv_bias"):
            torch.testing.assert_close(ours[key], ref[key])
        dt = torch.nn.functional.softplus(ours["cell.dt_bias"])
        assert ((dt > 1e-3 * (1 - 1e-5)) & (dt < 0.1 * (1 + 1e-5))).all()
    if cell == "transformer":
        for b in range(2):
            torch.testing.assert_close(ours[f"cell.blocks.{b}.age_bias"], ref[f"cell.blocks.{b}.age_bias"])
    torch.testing.assert_close(ours["policy_logstd"], ref["policy_logstd"])
