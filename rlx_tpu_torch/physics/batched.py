"""Batch-last small-linear-algebra helpers for the physics engine.

Everything here uses the layout ``[comp..., B]``: the env batch is the last
(contiguous) dimension and the small structural dims (3/6/nv) lead.  On the
GPU that makes a one-thread-per-env access pattern coalesced (thread ``b``
reads address ``b`` of each row).

Contractions are written as broadcast-multiply + sum over a leading axis,
the same formulation as the JAX engine, so both sum in the same order.
A ``*_const`` helper takes its constant as a float32 tensor already on the
device (the engine uploads its model's constants once, ``engine.constants``),
so a call makes no tensor from host data.
"""

import numpy as np
import torch


def matmul(A, B):
    """[m, k, B] @ [k, n, B] -> [m, n, B]."""
    return (A[:, :, None, :] * B[None, :, :, :]).sum(1)


def matmul_const(A, C):
    """[m, k, B] @ const [k, n] -> [m, n, B]."""
    return (A[:, :, None, :] * C[None, :, :, None]).sum(1)


def matvec(A, v):
    """[m, k, B] @ [k, B] -> [m, B]."""
    return (A * v[None, :, :]).sum(1)


def matvec_const(A, c):
    """[m, k, B] @ const [k] -> [m, B]."""
    return (A * c[None, :, None]).sum(1)


def transpose(A):
    return A.transpose(0, 1)


def cross(a, b):
    """[3, B] x [3, B] -> [3, B]."""
    return torch.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def skew(v):
    """[3, B] -> [3, 3, B]."""
    zero = torch.zeros_like(v[0])
    return torch.stack(
        [
            torch.stack([zero, -v[2], v[1]]),
            torch.stack([v[2], zero, -v[0]]),
            torch.stack([-v[1], v[0], zero]),
        ]
    )


def cross_motion(v, m):
    """Spatial motion cross product v x m; both [6, B] motion vectors
    ((angular, linear) world-origin Plücker)."""
    w, vl = v[:3], v[3:]
    mw, mv = m[:3], m[3:]
    return torch.cat([cross(w, mw), cross(w, mv) + cross(vl, mw)])


def cross_force(v, f):
    """Spatial force cross product v x* f; v [6, B] motion, f [6, B] force."""
    w, vl = v[:3], v[3:]
    n, fl = f[:3], f[3:]
    return torch.cat([cross(w, n) + cross(vl, fl), cross(w, fl)])


def quat_to_rot(q):
    """[4, B] (w, x, y, z) -> [3, 3, B]."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
        ]
    )


def quat_mul(a, b):
    """[4, B] Hamilton product."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def quat_integrate(q, omega_local, dt):
    """[4, B], [3, B] -> [4, B]; omega in the body frame."""
    speed = torch.sqrt((omega_local ** 2).sum(0))
    angle = speed * dt
    half = 0.5 * angle
    axis = omega_local / torch.clamp(speed, min=1e-9)[None]
    dq = torch.cat([torch.cos(half)[None], axis * torch.sin(half)[None]])
    out = quat_mul(q, dq)
    return out / torch.sqrt((out ** 2).sum(0))[None]


def rodrigues_matrices(axis):
    """(I, K, K @ K), float32 [3, 3] each, of the rotation about the
    constant ``axis`` [3]: R = I + sin K + (1 - cos) K^2."""
    K = np.array(
        [
            [0.0, -float(axis[2]), float(axis[1])],
            [float(axis[2]), 0.0, -float(axis[0])],
            [-float(axis[1]), float(axis[0]), 0.0],
        ],
        dtype=np.float32,
    )
    return np.eye(3, dtype=np.float32), K, K @ K


def rodrigues_sc(matrices, s, c):
    """Rotation from ``rodrigues_matrices`` (as float32 tensors on the
    device) and precomputed sin/cos [B] -> [3, 3, B]."""
    eye, K, KK = matrices
    return (
        eye[:, :, None]
        + s[None, None, :] * K[:, :, None]
        + (1.0 - c)[None, None, :] * KK[:, :, None]
    )


def ltdl_solve(M, rhs, lam):
    """Tree-sparse M x = rhs solve via the LTDL factorization
    (M = L^T D L, Featherstone RBDA §6.5, as MuJoCo's mj_factorM/mj_solveM).
    ``lam[d]`` is the preceding dof on d's kinematic chain (-1 at the root);
    only chain entries of M are read and there is no fill-in outside them.

    M: [n, n, B], rhs: [n, B] -> [n, B].
    """
    n = M.shape[0]
    H = {}
    for k in range(n):
        j = k
        while j != -1:
            H[(k, j)] = M[k, j]
            j = int(lam[j])
    inv_d = [None] * n
    for k in reversed(range(n)):
        inv_d[k] = 1.0 / H[(k, k)]
        i = int(lam[k])
        while i != -1:
            a = H[(k, i)] * inv_d[k]
            j = i
            while j != -1:
                H[(i, j)] = H[(i, j)] - a * H[(k, j)]
                j = int(lam[j])
            H[(k, i)] = a
            i = int(lam[i])
    # x = L^{-1} D^{-1} L^{-T} rhs
    x = [rhs[k] for k in range(n)]
    for i in reversed(range(n)):
        j = int(lam[i])
        while j != -1:
            x[j] = x[j] - H[(i, j)] * x[i]
            j = int(lam[j])
    x = [x[k] * inv_d[k] for k in range(n)]
    for i in range(n):
        j = int(lam[i])
        while j != -1:
            x[i] = x[i] - H[(i, j)] * x[j]
            j = int(lam[j])
    if n == 0:
        return rhs
    return torch.stack(x)
