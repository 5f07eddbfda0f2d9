"""The port's GAE (rlx_tpu_torch.ops.gae) against the JAX package's scan
and its Pallas kernel in interpret mode.  f32 throughout: rtol=atol=1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlx_tpu.ops.gae import gae_advantages as jax_gae
from rlx_tpu.ops.gae_pallas import gae_advantages_pallas
from rlx_tpu_torch.ops.gae import gae_advantages, gae_advantages_reference
from rlx_tpu_torch.ops.gae_cuda import (
    COLUMNS, TIME_CHUNK, WARPS, gae_advantages_cuda, gae_bytes, gae_geometry,
)
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

RTOL = ATOL = 1e-5


def _inputs(T, B, seed):
    rng = np.random.default_rng(seed)
    rewards, values, next_values = (rng.normal(size=(T, B)).astype(np.float32) for _ in range(3))
    terminations = rng.random((T, B)) < 0.2
    return rewards, values, next_values, terminations


@pytest.mark.parametrize("T,B", [(17, 5), (64, 130), (1, 7), (65, 33)])
def test_gae_matches_jax_scan(T, B):
    r, v, nv, d = _inputs(T, B, T)
    ref = jax_gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(nv), jnp.asarray(d), 0.99, 0.95)
    out = gae_advantages(torch.tensor(r), torch.tensor(v), torch.tensor(nv), torch.tensor(d), 0.99, 0.95)
    for o, x in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(x), rtol=RTOL, atol=ATOL)


def test_gae_matches_pallas_interpret():
    r, v, nv, d = _inputs(16, 256, 1)
    ref = gae_advantages_pallas(jnp.asarray(r), jnp.asarray(v), jnp.asarray(nv), jnp.asarray(d),
                                0.97, 0.9, block_b=128, interpret=True)
    out = gae_advantages_reference(torch.tensor(r), torch.tensor(v), torch.tensor(nv),
                                   torch.tensor(d), 0.97, 0.9)
    for o, x in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(x), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.float32])
def test_gae_termination_dtypes_and_bootstrap(dtype):
    """Terminations as bool, uint8 or float give the same result; a
    truncation (no termination) bootstraps from next_values."""
    r, v, nv, d = _inputs(8, 3, 2)
    base = gae_advantages_reference(torch.tensor(r), torch.tensor(v), torch.tensor(nv),
                                    torch.tensor(d), 0.99, 0.95)
    out = gae_advantages_reference(torch.tensor(r), torch.tensor(v), torch.tensor(nv),
                                   torch.tensor(d).to(dtype), 0.99, 0.95)
    for o, x in zip(out, base):
        torch.testing.assert_close(o, x, rtol=0, atol=0)
    one, zero, ten = torch.ones(1, 1), torch.zeros(1, 1), torch.full((1, 1), 10.0)
    adv, _ = gae_advantages_reference(one, zero, ten, torch.zeros(1, 1, dtype=dtype), 0.5, 1.0)
    assert adv.item() == pytest.approx(1.0 + 0.5 * 10.0)
    adv, _ = gae_advantages_reference(one, zero, ten, torch.ones(1, 1, dtype=dtype), 0.5, 1.0)
    assert adv.item() == pytest.approx(1.0)


def test_gae_cuda_wrapper_rejects_cpu_tensors_and_counts_bytes():
    r, v, nv, d = (torch.tensor(x) for x in _inputs(4, 4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        gae_advantages_cuda(r, v, nv, d, 0.99, 0.95)
    assert gae_bytes(64, 4096) == 64 * 4096 * (12 + 1 + 8)


@pytest.mark.parametrize("T,B", [(64, 4096), (64, 4097), (1, 1000), (65, 33), (200, 1), (0, 5)])
def test_gae_geometry_covers_every_column_and_row(T, B):
    """A block per 32 env columns with fewer than 32 to spare, time chunks
    covering every row, whole rows per warp while staging, and two staged
    arrays within the shared memory a block has without opting in."""
    launch = gae_geometry(T, B)
    assert launch.threads == 32 * WARPS <= 1024
    assert 0 <= launch.blocks * COLUMNS - B < COLUMNS
    assert 0 <= launch.chunks * TIME_CHUNK - T < TIME_CHUNK
    assert TIME_CHUNK % WARPS == 0
    assert launch.shared_bytes == 2 * TIME_CHUNK * COLUMNS * 4 <= 48 * 1024
