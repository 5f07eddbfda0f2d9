"""Wrapper of the categorical projection kernel (``csrc/projection.cu``).

Replaces ``rlx_tpu/ops/projection_pallas.py::categorical_projection_pallas``.
Bound by bytes (``projection_bytes``: the inputs read once, the output
written once); a block stages 8 rows of positions and masses in shared
memory and sums each output atom's hat weights over the input atoms in
order, with no atomics and coalesced loads and stores.  The plain version
is ``rlx_tpu_torch.ops.distributional.categorical_projection_reference``.

No backward: every caller projects a target under ``no_grad`` (the JAX
package's ``stop_gradient``), and the TPU kernel has none either, so an
input that requires grad while grad mode is on is refused.
"""

import ctypes

import torch

from rlx_tpu_torch.ops import _build


def _lib():
    lib = _build.load("projection")
    fn = lib.rlx_categorical_projection
    if fn.argtypes is None:
        P = ctypes.c_void_p
        fn.argtypes = [P, P, P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_float, ctypes.c_float, P]
        fn.restype = ctypes.c_int
        lib.rlx_projection_rows_per_block.argtypes = [ctypes.c_int]
        lib.rlx_projection_rows_per_block.restype = ctypes.c_int
    return lib


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
    lib = _lib()
    if lib.rlx_projection_rows_per_block(in_atoms) == 0:
        raise ValueError(f"{in_atoms} input atoms do not fit the kernel's shared-memory staging")
    out = torch.empty((z.shape[0], nr_atoms), dtype=torch.float32, device=z.device)
    delta_z = (float(v_max) - float(v_min)) / (nr_atoms - 1)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = lib.rlx_categorical_projection(
        z.data_ptr(), p.data_ptr(), out.data_ptr(), z.shape[0], in_atoms, nr_atoms,
        float(v_min), float(v_max), delta_z, stream,
    )
    if err != 0:
        raise RuntimeError(f"categorical projection kernel launch failed (cudaError {err})")
    categorical_projection_cuda.launches += 1
    return out.reshape(lead_shape + (nr_atoms,))


categorical_projection_cuda.launches = 0
