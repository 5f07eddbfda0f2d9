"""The port's C51 projections against the JAX package's: its plain dense
version (the CPU side of ``categorical_projection_dense``, the kernel's
plain version) and its scatter version against JAX's scatter, dense and
Pallas-interpret versions, on the same numpy inputs."""

import numpy as np
import pytest
import torch

from rlx_tpu_torch.ops.distributional import (
    categorical_projection,
    categorical_projection_dense,
    categorical_projection_reference,
)
from rlx_tpu_torch.ops.projection_cuda import (
    MAX_BLOCK_SHARED,
    MAX_OUT_ATOMS,
    WARPS_PER_BLOCK,
    categorical_projection_cuda,
    projection_geometry,
)
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

V_MIN, V_MAX = -10.0, 10.0


def _case(lead_shape, in_atoms, seed):
    """Positions straddle [v_min, v_max] (both clipping paths), and some land
    exactly on atoms, on the support's ends and on its middle; with three
    rows or more, row 1 is pinned at v_max (every b is A_out - 1)."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(-14.0, 14.0, size=lead_shape + (in_atoms,)).astype(np.float32)
    flat = z.reshape(-1, in_atoms)
    flat[0, :4] = [V_MIN, 0.0, V_MAX, V_MIN + 0.2]
    flat[-1, -3:] = [V_MAX + 3.0, V_MIN - 3.0, 5.0]
    if len(flat) >= 3:
        flat[1] = V_MAX
    logits = rng.normal(size=z.shape)
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return z, p.astype(np.float32)


# f32 on both sides; the sums run in other orders: 1e-6 on masses <= 1.  The
# Pallas interpreter's b may round one ulp apart (b up to 100 has an ulp of
# 7.6e-6, times a mass <= 1), so that reference gets 1e-5.
@pytest.mark.parametrize("lead_shape,in_atoms,nr_atoms", [
    ((37,), 101, 101),      # ragged N
    ((64,), 51, 101),       # A_in != nr_atoms
    ((3, 5), 11, 21),       # leading dims
    ((1,), 101, 11),        # fewer output atoms than input atoms
    ((2,), 257, 51),        # more than 8 chunks of input atoms, fewer output atoms
    ((5,), 101, 2),         # two output atoms
    ((3,), 101, 101),       # a row pinned at v_max
])
def test_plain_projection_matches_jax(lead_shape, in_atoms, nr_atoms):
    import jax.numpy as jnp

    from rlx_tpu.ops import distributional as jax_distributional
    from rlx_tpu.ops.projection_pallas import categorical_projection_pallas

    z, p = _case(lead_shape, in_atoms, seed=in_atoms + nr_atoms)
    args = (V_MIN, V_MAX, nr_atoms)
    refs = {
        "jax scatter": (jax_distributional.categorical_projection(jnp.asarray(z), jnp.asarray(p), *args),
                        1e-6),
        "jax dense": (jax_distributional.categorical_projection_dense(jnp.asarray(z), jnp.asarray(p), *args),
                      1e-6),
        "jax pallas": (categorical_projection_pallas(jnp.asarray(z), jnp.asarray(p), *args,
                                                     block_n=16, interpret=True), 1e-5),
    }
    zt, pt = torch.tensor(z), torch.tensor(p)
    ours = {
        "plain": categorical_projection_reference(zt, pt, *args),
        "dispatch": categorical_projection_dense(zt, pt, *args),
        "scatter": categorical_projection(zt, pt, *args),
    }
    for name, out in ours.items():
        assert out.shape == lead_shape + (nr_atoms,), name
        np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=1e-5, err_msg=name)
        for ref_name, (ref, tol) in refs.items():
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol, atol=tol,
                                       err_msg=f"{name} vs {ref_name}")


def test_projection_puts_on_atom_mass_on_that_atom():
    """A position on an atom keeps all its mass there; one beyond the
    support lands on its end."""
    z = torch.tensor([[V_MIN, 0.0, V_MAX + 5.0]])
    p = torch.tensor([[0.25, 0.5, 0.25]])
    for fn in (categorical_projection, categorical_projection_reference):
        out = fn(z, p, V_MIN, V_MAX, 11)[0]
        expected = torch.zeros(11)
        expected[0], expected[5], expected[10] = 0.25, 0.5, 0.25
        torch.testing.assert_close(out, expected, rtol=0, atol=0)


@pytest.mark.parametrize("N,A_in,A_out", [
    (8192, 101, 101),       # the FastTD3 path's shape
    (8193, 101, 101),       # ragged last block
    (1, 51, 101),
    (64, 8192, 101),        # past the 6,144 input atoms the dense kernel staged
    (1027, 101, 11),
    (5, 101, 2),
    (0, 101, 101),
])
def test_projection_geometry_covers_every_row_and_atom(N, A_in, A_out):
    """A warp per row: the blocks cover every row with fewer than a block's
    rows to spare, the 32-atom chunks every input atom, and a block's
    accumulators fit in the shared memory it has without opting in."""
    launch = projection_geometry(N, A_in, A_out)
    assert launch.threads == 32 * WARPS_PER_BLOCK
    assert 0 <= launch.blocks * WARPS_PER_BLOCK - N < WARPS_PER_BLOCK
    assert 0 <= launch.chunks * 32 - A_in < 32
    assert launch.shared_bytes == WARPS_PER_BLOCK * A_out * 4 <= MAX_BLOCK_SHARED


def test_projection_limits_output_atoms_not_input_atoms():
    assert projection_geometry(8, 1 << 20, 101).chunks == (1 << 20) // 32
    assert projection_geometry(8, 101, MAX_OUT_ATOMS).shared_bytes == MAX_BLOCK_SHARED
    with pytest.raises(ValueError, match=f"at most {MAX_OUT_ATOMS} output atoms"):
        projection_geometry(8, 101, MAX_OUT_ATOMS + 1)
    z, p = (torch.tensor(x) for x in _case((4,), 101, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        categorical_projection_cuda(z, p, V_MIN, V_MAX, 101)
