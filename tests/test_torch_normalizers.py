"""The port's running normalizers against the JAX package's: the same
batches through both, every state leaf compared after each update."""

import numpy as np
import pytest
import torch

from rlx_tpu_torch.ops import normalizers
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)


def _assert_states_close(ours, ref, tol):
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=tol, atol=tol, err_msg=k)


# f32 on both sides; means and variances are reduced in other orders
TOL = 1e-6


def test_obs_normalizer_matches_jax():
    from rlx_tpu.ops import normalizers as jax_normalizers

    rng = np.random.default_rng(0)
    state, ref = normalizers.obs_normalizer_init((5,)), jax_normalizers.obs_normalizer_init((5,))
    _assert_states_close(state, ref, 0.0)
    for i in range(4):
        batch = (3.0 * rng.normal(size=(16, 5)) + i).astype(np.float32)
        state = normalizers.obs_normalizer_update(state, torch.tensor(batch))
        ref = jax_normalizers.obs_normalizer_update(ref, batch)
        _assert_states_close(state, ref, TOL)
    obs = rng.normal(size=(7, 5)).astype(np.float32)
    np.testing.assert_allclose(normalizers.obs_normalize(state, torch.tensor(obs)).numpy(),
                               np.asarray(jax_normalizers.obs_normalize(ref, obs)), rtol=TOL, atol=TOL)
    # population variance, count from 1e-4
    assert float(state["count"]) == pytest.approx(64 + 1e-4, rel=1e-6)


def test_reward_normalizer_matches_jax():
    from rlx_tpu.ops import normalizers as jax_normalizers

    rng = np.random.default_rng(1)
    nr_envs = 6
    state, ref = normalizers.reward_normalizer_init(nr_envs), jax_normalizers.reward_normalizer_init(nr_envs)
    _assert_states_close(state, ref, 0.0)
    for _ in range(5):
        reward = rng.normal(size=nr_envs).astype(np.float32)
        terminated = rng.random(nr_envs) < 0.2
        truncated = rng.random(nr_envs) < 0.2
        state = normalizers.reward_normalizer_update(
            state, torch.tensor(reward), torch.tensor(terminated), torch.tensor(truncated), 0.99)
        ref = jax_normalizers.reward_normalizer_update(ref, reward, terminated, truncated, 0.99)
        _assert_states_close(state, ref, TOL)
    np.testing.assert_allclose(normalizers.reward_normalize(state, torch.tensor(reward)).numpy(),
                               np.asarray(jax_normalizers.reward_normalize(ref, reward)), rtol=TOL, atol=TOL)
