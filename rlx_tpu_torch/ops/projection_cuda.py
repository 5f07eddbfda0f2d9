"""Wrapper of the categorical projection kernel (``csrc/projection.cu``).

Replaces ``rlx_tpu/ops/projection_pallas.py::categorical_projection_pallas``.
Bound by bytes (``projection_bytes``: the inputs read once, the output
written once).  A scatter: one warp per row puts each input mass on its two
neighbouring atoms in a row accumulator in shared memory; lanes whose
masses land on one atom are summed by shuffles in a fixed order before one
of them adds, with no atomics, so the result is the same bits on every
launch.  Loads and stores are coalesced.  The launch shape is
``projection_geometry``.  The plain version is
``rlx_tpu_torch.ops.distributional.categorical_projection_reference``.

No backward: every caller projects a target under ``no_grad`` (the JAX
package's ``stop_gradient``), and the TPU kernel has none either, so an
input that requires grad while grad mode is on is refused.
"""

import ctypes

import torch

from rlx_tpu_torch.ops import _build

WARPS_PER_BLOCK = 8            # one row per warp (``kWarps`` in the kernel)
ATOM_CHUNK = 32                # input atoms a warp reads at once
MAX_BLOCK_SHARED = 48 * 1024   # shared memory a block has without opting in to more
MAX_OUT_ATOMS = MAX_BLOCK_SHARED // (4 * WARPS_PER_BLOCK)


def projection_geometry(N, A_in, A_out):
    """Launch of the kernel for ``N`` rows of ``A_in`` input atoms onto
    ``A_out`` atoms: a warp per row, each with an ``[A_out]`` f32
    accumulator in shared memory.  ``chunks`` is the number
    of 32-atom chunks a warp walks.  Raises for more than ``MAX_OUT_ATOMS``
    output atoms; ``A_in`` is not limited."""
    if A_out > MAX_OUT_ATOMS:
        raise ValueError(f"the projection kernel takes at most {MAX_OUT_ATOMS} output atoms "
                         f"(a block's accumulators fit in {MAX_BLOCK_SHARED} bytes of shared "
                         f"memory), got {A_out}")
    return _build.Launch(
        blocks=-(-N // WARPS_PER_BLOCK), threads=32 * WARPS_PER_BLOCK,
        shared_bytes=WARPS_PER_BLOCK * A_out * 4, chunks=-(-A_in // ATOM_CHUNK),
    )


def _lib():
    fn = _build.load("projection").rlx_categorical_projection
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, P, P, I, I, I, F, F, F, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def projection_bytes(N, A_in, A_out):
    """Bytes the function must move: f32 positions and masses ``[N, A_in]``
    read once, the f32 ``[N, A_out]`` projection written once."""
    return N * (2 * A_in + A_out) * 4


def projection_flops(N, A_in):
    """Least operations: per input atom a clip (2), the shift and division
    (2), floor/ceil (2), two weights (2) and two accumulations (2)."""
    return 10 * N * A_in


def categorical_projection_cuda(target_z, probs, v_min, v_max, nr_atoms):
    """Same contract as ``distributional.categorical_projection_dense``;
    CUDA tensors only."""
    if not target_z.is_cuda:
        raise ValueError("categorical_projection_cuda takes CUDA tensors")
    if torch.is_grad_enabled() and (target_z.requires_grad or probs.requires_grad):
        raise RuntimeError(
            "categorical_projection_cuda has no backward: project targets under torch.no_grad()"
        )
    if target_z.dtype != torch.float32:
        raise ValueError(f"target_z must be float32, got {target_z.dtype}")
    if probs.shape != target_z.shape or probs.device != target_z.device:
        raise ValueError(f"probs must be {tuple(target_z.shape)} on {target_z.device}")
    nr_atoms = int(nr_atoms)
    if nr_atoms < 2:
        raise ValueError("nr_atoms must be at least 2")
    in_atoms = target_z.shape[-1]
    lead_shape = target_z.shape[:-1]
    z = target_z.reshape(-1, in_atoms).contiguous()
    p = probs.reshape(-1, in_atoms).to(torch.float32).contiguous()
    launch = projection_geometry(z.shape[0], in_atoms, nr_atoms)
    out = torch.empty((z.shape[0], nr_atoms), dtype=torch.float32, device=z.device)
    delta_z = (float(v_max) - float(v_min)) / (nr_atoms - 1)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = _lib()(
        z.data_ptr(), p.data_ptr(), out.data_ptr(), z.shape[0], in_atoms, nr_atoms,
        float(v_min), float(v_max), delta_z,
        launch.blocks, launch.threads, launch.shared_bytes, stream,
    )
    if err != 0:
        raise RuntimeError(f"categorical projection kernel launch failed (cudaError {err})")
    categorical_projection_cuda.launches += 1
    return out.reshape(lead_shape + (nr_atoms,))


categorical_projection_cuda.launches = 0
