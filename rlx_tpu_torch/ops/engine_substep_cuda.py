"""Wrapper of the physics-substep kernel (``csrc/engine_substep.cu``).

Replaces ``rlx_tpu/ops/engine_substep_pallas.py::step_pallas``.  Bound by
operations: the per-env work (``substep_flops``) is large against the state
each launch moves (``substep_bytes``).  One thread per env keeps the whole
state in the thread across all substeps; the model's tables sit in constant
memory.  The plain version is ``rlx_tpu_torch.physics.engine.step_reference``.

The public API is batch-first like ``engine.step``; the wrapper hands the
kernel batch-last ``[comp, B]`` buffers (coalesced per-thread access) and
transposes back.
"""

import ctypes

import numpy as np
import torch

from rlx_tpu_torch.ops import _build
from rlx_tpu_torch.physics.engine import (
    DomainParams, dof_structure, limit_damping, quat_to_mat_np,
)
from rlx_tpu_torch.physics.model import FREE, HINGE

MAX_NBODY, MAX_NQ, MAX_NV, MAX_NU, MAX_NCON = 24, 32, 24, 24, 32

_I, _F = ctypes.c_int, ctypes.c_float


class ModelI(ctypes.Structure):
    _fields_ = [
        ("nbody", _I), ("nq", _I), ("nv", _I), ("nu", _I), ("ncon", _I),
        ("parent", _I * MAX_NBODY),
        ("jnt_type", _I * MAX_NBODY),
        ("qpos_adr", _I * MAX_NBODY),
        ("dof_adr", _I * MAX_NBODY),
        ("jnt_limited", _I * MAX_NBODY),
        ("frame_identity", _I * MAX_NBODY),
        ("lam", _I * MAX_NV),
        ("dof_body", _I * MAX_NV),
        ("act_dof", _I * MAX_NU),
        ("act_qpos", _I * MAX_NU),
        ("act_is_position", _I * MAX_NU),
        ("con_body", _I * MAX_NCON),
    ]


class ModelF(ctypes.Structure):
    _fields_ = [
        ("timestep", _F), ("gravity", _F * 3), ("omega_c", _F), ("limit_stiffness", _F),
        ("frame_rot", _F * 9 * MAX_NBODY),
        ("body_pos", _F * 3 * MAX_NBODY),
        ("icom_rot", _F * 9 * MAX_NBODY),
        ("body_ipos", _F * 3 * MAX_NBODY),
        ("body_mass", _F * MAX_NBODY),
        ("body_inertia", _F * 3 * MAX_NBODY),
        ("jnt_axis", _F * 3 * MAX_NBODY),
        ("jnt_pos", _F * 3 * MAX_NBODY),
        ("rod_K", _F * 9 * MAX_NBODY),
        ("rod_KK", _F * 9 * MAX_NBODY),
        ("jnt_lo", _F * MAX_NBODY),
        ("jnt_hi", _F * MAX_NBODY),
        ("jnt_dlim", _F * MAX_NBODY),
        ("dof_armature", _F * MAX_NV),
        ("dof_damping", _F * MAX_NV),
        ("dof_frictionloss", _F * MAX_NV),
        ("act_kp", _F * MAX_NU),
        ("act_kv", _F * MAX_NU),
        ("act_gear", _F * MAX_NU),
        ("act_lo", _F * MAX_NU),
        ("act_hi", _F * MAX_NU),
        ("con_pos", _F * 3 * MAX_NCON),
        ("con_radius", _F * MAX_NCON),
        ("con_friction", _F * MAX_NCON),
        ("con_k", _F * MAX_NCON),
        ("con_d", _F * MAX_NCON),
        ("con_meff", _F * MAX_NCON),
        ("con_dw", _F * MAX_NCON),
        ("con_kcap", _F * MAX_NCON),
        ("con_dcap", _F * MAX_NCON),
        ("con_kt", _F * MAX_NCON),
        ("con_ct", _F * MAX_NCON),
    ]


def _fill(struct, name, values):
    """Copy ``values`` (any shape) into the flat prefix of a table field."""
    flat = np.asarray(values, dtype=np.float64).reshape(-1)
    view = np.ctypeslib.as_array(getattr(struct, name)).reshape(-1)
    view[: flat.size] = flat


def check_model(model):
    ncon = len(model.con_body)
    nu = len(model.act_dof)
    for what, n, cap in (("nbody", model.nbody, MAX_NBODY), ("nq", model.nq, MAX_NQ),
                         ("nv", model.nv, MAX_NV), ("nu", nu, MAX_NU), ("ncon", ncon, MAX_NCON)):
        if n > cap:
            raise ValueError(f"model {what}={n} exceeds the substep kernel's maximum {cap}")


def model_tables(model, contact_timeconst, contact_dampratio, limit_stiffness):
    """Host-side constant tables of ``model`` for the kernel (float64 host
    arithmetic rounded to float32, as the plain engine's Python floats)."""
    check_model(model)
    ti, tf = ModelI(), ModelF()
    nbody, nv = model.nbody, model.nv
    nu, ncon = len(model.act_dof), len(model.con_body)
    ti.nbody, ti.nq, ti.nv, ti.nu, ti.ncon = nbody, model.nq, nv, nu, ncon
    lam, dof_body = dof_structure(model)
    dt = float(model.timestep)

    frame_rot = [quat_to_mat_np(q) for q in model.body_quat]
    _fill(ti, "parent", model.parent)
    _fill(ti, "jnt_type", model.jnt_type)
    _fill(ti, "qpos_adr", model.qpos_adr)
    _fill(ti, "dof_adr", model.dof_adr)
    _fill(ti, "jnt_limited", model.jnt_limited)
    _fill(ti, "frame_identity", [np.allclose(C, np.eye(3)) for C in frame_rot])
    _fill(ti, "lam", lam)
    _fill(ti, "dof_body", dof_body)
    _fill(ti, "act_dof", model.act_dof)
    _fill(ti, "act_qpos", [int(model.qpos_adr[int(b)]) for b in model.act_joint_body])
    _fill(ti, "act_is_position", model.act_is_position)
    _fill(ti, "con_body", model.con_body)
    for k in range(nv):
        if not (lam[k] < k):
            raise ValueError("dof chains must point to lower dof indices")

    tf.timestep = dt
    _fill(tf, "gravity", model.gravity)
    tf.omega_c = 1.0 / contact_timeconst
    tf.limit_stiffness = limit_stiffness
    _fill(tf, "frame_rot", frame_rot)
    _fill(tf, "body_pos", model.body_pos)
    _fill(tf, "icom_rot", [quat_to_mat_np(q) for q in model.body_iquat])
    _fill(tf, "body_ipos", model.body_ipos)
    _fill(tf, "body_mass", model.body_mass)
    _fill(tf, "body_inertia", model.body_inertia)
    _fill(tf, "jnt_axis", model.jnt_axis)
    _fill(tf, "jnt_pos", model.jnt_pos)
    K, KK, lo, hi, dlim = [], [], [], [], []
    for i in range(nbody):
        a = model.jnt_axis[i]
        k = np.array([[0.0, -float(a[2]), float(a[1])],
                      [float(a[2]), 0.0, -float(a[0])],
                      [-float(a[1]), float(a[0]), 0.0]], dtype=np.float32)
        K.append(k)
        KK.append(k @ k)
        lo.append(float(model.jnt_range[i, 0]))
        hi.append(float(model.jnt_range[i, 1]))
        limited = int(model.jnt_type[i]) == HINGE and bool(model.jnt_limited[i])
        dlim.append(limit_damping(model, limit_stiffness, int(model.dof_adr[i])) if limited else 0.0)
    _fill(tf, "rod_K", K)
    _fill(tf, "rod_KK", KK)
    _fill(tf, "jnt_lo", lo)
    _fill(tf, "jnt_hi", hi)
    _fill(tf, "jnt_dlim", dlim)
    _fill(tf, "dof_armature", model.dof_armature)
    _fill(tf, "dof_damping", model.dof_damping)
    _fill(tf, "dof_frictionloss", model.dof_frictionloss)
    _fill(tf, "act_kp", model.act_kp)
    _fill(tf, "act_kv", model.act_kv)
    _fill(tf, "act_gear", model.act_gear)
    _fill(tf, "act_lo", [float(r[0]) for r in model.act_forcerange])
    _fill(tf, "act_hi", [float(r[1]) for r in model.act_forcerange])

    omega_c = 1.0 / contact_timeconst
    con = {n: [] for n in ("k", "d", "meff", "dw", "kcap", "dcap", "kt", "ct")}
    for c in range(ncon):
        m_eff = float(model.con_meff[c])
        m_app = float(model.con_m_app[c]) if len(model.con_m_app) else m_eff
        m_app_t = float(model.con_m_app_t[c]) if len(model.con_m_app_t) else m_app
        con["k"].append(min(m_eff * omega_c ** 2, 2.0 * m_app / dt ** 2))
        con["d"].append(min(2.0 * contact_dampratio * m_eff * omega_c, 0.7 * m_app / dt))
        con["meff"].append(m_eff)
        con["dw"].append(2.0 * contact_dampratio * m_eff)
        con["kcap"].append(2.0 * m_app / dt ** 2)
        con["dcap"].append(0.7 * m_app / dt)
        con["kt"].append(0.3 * m_app_t / dt ** 2)
        con["ct"].append(0.4 * m_app_t / dt)
    _fill(tf, "con_pos", model.con_pos)
    _fill(tf, "con_radius", model.con_radius)
    _fill(tf, "con_friction", model.con_friction)
    for n, values in con.items():
        _fill(tf, "con_" + n, values)
    return ti, tf


def _lib():
    lib = _build.load("engine_substep")
    fn = lib.rlx_engine_substep
    if fn.argtypes is None:
        sizes = lib.rlx_engine_table_sizes
        sizes.argtypes = [ctypes.c_void_p] * 3
        sizes.restype = None
        si, sf, maxima = ctypes.c_int(), ctypes.c_int(), (ctypes.c_int * 5)()
        sizes(ctypes.byref(si), ctypes.byref(sf), maxima)
        expected = (ctypes.sizeof(ModelI), ctypes.sizeof(ModelF),
                    [MAX_NBODY, MAX_NQ, MAX_NV, MAX_NU, MAX_NCON])
        if (si.value, sf.value, list(maxima)) != expected:
            raise RuntimeError(
                f"kernel tables ({si.value}, {sf.value}, {list(maxima)}) do not match "
                f"the wrapper's {expected}"
            )
        P = ctypes.c_void_p
        fn.argtypes = [P, P, P, P, P, ctypes.c_int, P, P, P, P, P,
                       ctypes.c_int, ctypes.c_int, P]
        fn.restype = ctypes.c_int
    return fn


_DR_SHAPES = {
    "mass_scale": "nbody", "kp_scale": "nu", "kv_scale": "nu", "forcerange_scale": "nu",
    "ctrl_offset": "nu", "gravity": 3,
}


def _dr_tensors(model, dr, B, device):
    """Per-field contiguous float32 batch-last tensors (None where unset)."""
    lead = {"nbody": model.nbody, "nu": len(model.act_dof), 3: 3}
    out = []
    for name in DomainParams._fields:
        val = None if dr is None else getattr(dr, name)
        if val is not None:
            shape = (lead[_DR_SHAPES[name]], B) if name in _DR_SHAPES else (B,)
            if tuple(val.shape) != shape or val.device != device:
                raise ValueError(f"DomainParams.{name} must be {shape} on {device}")
            val = val.to(torch.float32).contiguous()
        out.append(val)
    return out


class _TableCache:
    """Host tables per (model, contact and limit parameters)."""

    def __init__(self):
        self._entries = {}

    def get(self, model, *params):
        key = (id(model),) + params
        entry = self._entries.get(key)
        if entry is None or entry[0] is not model:
            entry = (model, model_tables(model, *params))
            self._entries[key] = entry
        return entry[1]


_tables = _TableCache()


def step_cuda(model, qpos, qvel, ctrl, nr_substeps=1,
              contact_timeconst=0.015, contact_dampratio=1.0, limit_stiffness=200.0,
              dr=None, terrain=None, ctrl_sequence=None, contact_state=None):
    """Same signature and returns as ``engine.step``; CUDA tensors only."""
    if terrain is not None:
        raise NotImplementedError("the substep kernel covers plane ground only")
    if not qpos.is_cuda:
        raise ValueError("step_cuda takes CUDA tensors")
    device = qpos.device
    B = qpos.shape[0]
    nu, ncon = len(model.act_dof), len(model.con_body)
    if qpos.shape != (B, model.nq) or qvel.shape != (B, model.nv):
        raise ValueError(f"qpos/qvel must be [B, {model.nq}] / [B, {model.nv}]")
    for t in (qpos, qvel, ctrl, ctrl_sequence, contact_state):
        if t is not None and (t.dtype != torch.float32 or t.device != device):
            raise ValueError(f"step_cuda takes float32 tensors on {device}")
    ti, tf = _tables.get(model, float(contact_timeconst), float(contact_dampratio),
                         float(limit_stiffness))

    qposT = qpos.T.contiguous()
    qvelT = qvel.T.contiguous()
    if ctrl_sequence is not None:
        if ctrl_sequence.shape[1:] != (B, nu):
            raise ValueError(f"ctrl_sequence must be [S, {B}, {nu}]")
        ctrlT = ctrl_sequence.transpose(1, 2).contiguous()  # [S, nu, B]
        nr_substeps, per_substep = ctrl_sequence.shape[0], 1
    else:
        if ctrl.shape != (B, nu):
            raise ValueError(f"ctrl must be [{B}, {nu}]")
        ctrlT = ctrl.T.contiguous()                          # [nu, B]
        per_substep = 0
    anchors_in = anchors_out = None
    if contact_state is not None:
        if contact_state.shape != (B, ncon, 2):
            raise ValueError(f"contact_state must be [{B}, {ncon}, 2]")
        if ncon > 0:
            anchors_in = contact_state.permute(1, 2, 0).contiguous()
            anchors_out = torch.empty_like(anchors_in)
    dr_fields = _dr_tensors(model, dr, B, device)
    dr_ptrs = (ctypes.c_void_p * len(dr_fields))(
        *[None if t is None else t.data_ptr() for t in dr_fields]
    )
    qpos_out = torch.empty_like(qposT)
    qvel_out = torch.empty_like(qvelT)

    ptr = lambda t: None if t is None else t.data_ptr()
    err = _lib()(
        ctypes.addressof(ti), ctypes.addressof(tf),
        ptr(qposT), ptr(qvelT), ptr(ctrlT), per_substep, ptr(anchors_in),
        ptr(qpos_out), ptr(qvel_out), ptr(anchors_out),
        ctypes.addressof(dr_ptrs), B, int(nr_substeps),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"substep kernel launch failed (cudaError {err})")
    step_cuda.launches += 1

    if contact_state is None:
        return qpos_out.T, qvel_out.T
    if ncon == 0:
        return qpos_out.T, qvel_out.T, torch.zeros((B, 0, 2), device=device)
    return qpos_out.T, qvel_out.T, anchors_out.permute(2, 0, 1)


step_cuda.launches = 0


# ---------------------------------------------------------------- roofline


def _chain(lam, d):
    out = []
    while d != -1:
        out.append(d)
        d = int(lam[d])
    return out


def substep_flops(model, dr=False):
    """f32 operations of one env-substep, counted from the kernel source
    (a multiply, add, compare-select, divide, sqrt or transcendental call
    each count as one operation)."""
    lam, _ = dof_structure(model)
    frame_rot = [quat_to_mat_np(q) for q in model.body_quat]
    CROSS, MATVEC, MATMUL, INERTIA_MATVEC = 9, 15, 45, 15 + 18 + 3 + 9
    ops = 0
    for i in range(model.nbody):
        jt = int(model.jnt_type[i])
        ops += 0 if np.allclose(frame_rot[i], np.eye(3)) else MATMUL   # R_frame
        ops += MATVEC + 3                                                # p_frame
        if jt == FREE:
            ops += 36                                                    # quat_to_rot
            ops += 3 * CROSS                                             # Jacobian columns
            ops += 6 * 11 + 3 * 5                                        # own, moving velocity
        elif jt == HINGE:
            ops += 2 + 9 * 4 + MATMUL + 9 + MATVEC + 3                   # rodrigues, R, p
            ops += 2 * MATVEC + 3 + CROSS                                # Jacobian column
            ops += 6                                                     # own velocity
        ops += 6 + 3 * CROSS + 6                                         # v, zeta
        ops += MATMUL + 9 + MATVEC + 3 + 15 + 9 * 7 + 3                  # spatial inertia
        ops += 2 * INERTIA_MATVEC + 3 * CROSS + 9                        # bias wrench
        ops += 6                                                         # f - w
        if int(model.parent[i]) >= 0:
            ops += 13 + 6                                                # composite sums
    for d in range(model.nv):
        ops += INERTIA_MATVEC + 11 * len(_chain(lam, d)) + 1             # CRBA row
        ops += 11 + 1                                                    # C, tau - C
        ops += 2 + 2 + 2                                                 # damping, frictionloss
        anc = _chain(lam, d)[1:]
        ops += 1 + sum(2 + 2 * len(_chain(lam, i)) for i in anc)         # factor
        ops += 2 * 2 * len(anc) + 1                                      # solves
        ops += 2 + 2                                                     # integrate qvel, qpos
    ops += len(model.con_body) * (MATVEC + 3 + CROSS + 3 + 6 + 1 + 4 + 16 + 10 + CROSS + 6)
    ops += len(model.act_dof) * 8
    ops += sum(8 for i in range(model.nbody)
               if int(model.jnt_type[i]) == HINGE and bool(model.jnt_limited[i]))
    ops += sum(45 for i in range(model.nbody) if int(model.jnt_type[i]) == FREE)  # quaternion
    return ops


def substep_bytes(model, B, with_anchors):
    """Bytes one launch with a held ``ctrl`` must move: qpos, qvel, ctrl (and
    anchors) read once, qpos, qvel (and anchors) written once, all float32."""
    ncon, nu = len(model.con_body), len(model.act_dof)
    anchors = 2 * ncon * 2 if with_anchors else 0
    return 4 * B * (2 * (model.nq + model.nv) + nu + anchors)
