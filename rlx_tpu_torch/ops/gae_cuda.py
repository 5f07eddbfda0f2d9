"""Wrapper of the GAE kernel (``csrc/gae.cu``).

Replaces ``rlx_tpu/ops/gae_pallas.py::gae_advantages_pallas``.  Bound by
bytes: each input element is read once and each output written once.  A
block of 16 warps takes 32 env columns; for each chunk of 64 time rows, all
warps stage each row's delta and discount in shared memory from coalesced
loads, one warp walks the chunk from its last row to its first with the
running advantage in a register, and all warps store the results.  The
launch shape is ``gae_geometry``.  The plain version is
``rlx_tpu_torch.ops.gae.gae_advantages_reference``.
"""

import ctypes

import torch

from rlx_tpu_torch.ops import _build

COLUMNS = 32        # env columns per block (``kCols`` in the kernel)
WARPS = 16          # ``kWarps``
TIME_CHUNK = 64     # time rows staged at once (``kChunk``)


def gae_geometry(T, B):
    """Launch of the kernel on ``[T, B]``: a block per 32 env columns, two
    f32 ``[TIME_CHUNK, 32]`` arrays of shared memory, ``chunks`` time
    chunks walked one after another."""
    return _build.Launch(blocks=-(-B // COLUMNS), threads=32 * WARPS,
                         shared_bytes=2 * TIME_CHUNK * COLUMNS * 4, chunks=-(-T // TIME_CHUNK))


def _lib():
    fn = _build.load("gae").rlx_gae
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, P, P, P, I, P, P, I, I, F, F, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def gae_bytes(T, B, terminations_itemsize=1):
    """Bytes the function must move: 3 f32 inputs and the terminations read
    once, 2 f32 outputs written once."""
    return T * B * (3 * 4 + terminations_itemsize + 2 * 4)


def gae_advantages_cuda(rewards, values, next_values, terminations, gamma, gae_lambda):
    """Same contract as ``gae.gae_advantages``; CUDA tensors only."""
    if not rewards.is_cuda:
        raise ValueError("gae_advantages_cuda takes CUDA tensors")
    T, B = rewards.shape
    for name, t in (("rewards", rewards), ("values", values), ("next_values", next_values)):
        if t.dtype != torch.float32 or t.shape != (T, B) or t.device != rewards.device:
            raise ValueError(f"{name} must be float32 [{T}, {B}] on {rewards.device}")
    if terminations.shape != (T, B) or terminations.device != rewards.device:
        raise ValueError(f"terminations must be [{T}, {B}] on {rewards.device}")
    if terminations.dtype in (torch.bool, torch.uint8):
        terminations_are_float = 0
    elif terminations.dtype == torch.float32:
        terminations_are_float = 1
    else:
        raise ValueError(f"terminations must be bool, uint8 or float32, got {terminations.dtype}")
    rewards, values, next_values, terminations = (
        t.contiguous() for t in (rewards, values, next_values, terminations)
    )
    advantages = torch.empty_like(rewards)
    returns = torch.empty_like(rewards)
    launch = gae_geometry(T, B)
    stream = torch.cuda.current_stream(rewards.device).cuda_stream
    err = _lib()(
        rewards.data_ptr(), values.data_ptr(), next_values.data_ptr(), terminations.data_ptr(),
        terminations_are_float, advantages.data_ptr(), returns.data_ptr(), T, B,
        float(gamma), float(gamma) * float(gae_lambda),
        launch.blocks, launch.threads, launch.shared_bytes, stream,
    )
    if err != 0:
        raise RuntimeError(f"GAE kernel launch failed (cudaError {err})")
    gae_advantages_cuda.launches += 1
    return advantages, returns


gae_advantages_cuda.launches = 0
