"""Wrapper of the physics-substep kernel (``csrc/engine_substep.cu``).

Replaces ``rlx_tpu/ops/engine_substep_pallas.py::step_pallas``.  Bound by
operations: the per-env work (``substep_flops``) is large against the state
each launch moves (``substep_bytes``).  The plain version is
``rlx_tpu_torch.physics.engine.step_reference``.

The kernel runs a group of lanes per env (``lanes_per_env``: a warp, or half
a warp once the batch fills the card), against the four limits of a
one-thread-per-env design:

1. parallelism: the lanes split each phase over the model's parallel work,
   by a schedule this module computes from the model in numpy
   (``body_levels``, ``chain_entries``, ``ltdl_schedule``);
2. local memory: each env's state lives in dynamic shared memory laid out
   from the model's counts (``env_layout``), with M and its factor as lists
   of chain entries; a model whose block would not fit raises;
3. per-launch constant uploads: the model's numeric tables and the schedule
   are one flat 32-bit device buffer (``model_tables``; floats bit-cast),
   uploaded once per model and contact/limit parameters (``_TableCache``)
   and staged into shared memory once per block; its header names are
   checked against the library's when it loads;
4. transposes: qpos, qvel, ctrl (or ctrl_sequence) and contact_state go in
   and out batch-first, as ``engine.step`` takes and returns them.
"""

import ctypes

import numpy as np
import torch

from rlx_tpu_torch.ops import _build
from rlx_tpu_torch.physics.engine import (
    DomainParams, dof_structure, limit_damping, quat_to_mat_np,
)
from rlx_tpu_torch.physics.model import FREE, HINGE

BLOCK_THREADS = 128         # lanes_per_env lanes per env, BLOCK_THREADS / lanes_per_env envs a block
MAX_BLOCK_SHARED = 232448   # bytes of shared memory a Hopper block can opt in to

# The table header, in the kernel's order (TABLE_SCALARS, TABLE_SECTIONS).
SCALARS = (
    "nbody", "nq", "nv", "nu", "ncon", "nent", "free_block", "nlevel", "ngroup",
    "ndepth", "env_floats", "timestep", "gravity_x", "gravity_y", "gravity_z", "omega_c",
    "limit_stiffness", "o_qpos", "o_qvel", "o_anchor", "o_gneg", "o_R", "o_p",
    "o_cols", "o_vel", "o_mov", "o_zeta", "o_Ic", "o_f", "o_wc", "o_M",
    "o_L", "o_x", "o_inv_d",
)
SECTIONS = (
    "parent", "jnt_type", "qpos_adr", "dof_adr", "frame_identity", "frame_rot",
    "body_pos", "icom_rot", "body_ipos", "body_mass", "body_inertia",
    "jnt_axis", "jnt_pos", "level_start", "level_body",
    "child_start", "child_list", "bcon_start", "bcon_list", "dof_body",
    "dof_armature", "dof_damping", "dof_frictionloss", "dof_limited",
    "dof_qadr", "dof_lo", "dof_hi", "dof_dlim", "dact_start", "dact_list",
    "ent_start", "ent_d", "ent_j", "act_qpos", "act_is_position", "act_kp",
    "act_kv", "act_gear", "act_lo", "act_hi", "con_body", "con_pos",
    "con_radius", "con_friction", "con_k", "con_d", "con_meff", "con_dw",
    "con_kcap", "con_dcap", "con_kt", "con_ct", "grp_start", "grp_ent",
    "grp_diag", "ftgt_start", "ftgt_entry", "ftgt_cstart", "fc_ki", "fc_kj",
    "stgt_start", "stgt_dof", "stgt_cstart", "sc_e", "sc_i", "depth_start",
    "depth_dof",
)
_FLOAT_SCALARS = {"timestep", "gravity_x", "gravity_y", "gravity_z", "omega_c",
                  "limit_stiffness"}


# ---------------------------------------------------------------- schedule


def _chain(lam, d):
    out = []
    while d != -1:
        out.append(d)
        d = int(lam[d])
    return out


def body_levels(model):
    """Bodies by depth in the kinematic tree: ``[[root bodies], [their
    children], ...]``, ascending index within a level."""
    levels, depth = [], []
    for i in range(model.nbody):
        par = int(model.parent[i])
        if par >= i:
            raise ValueError("bodies must come after their parents")
        depth.append(0 if par < 0 else depth[par] + 1)
        if depth[i] == len(levels):
            levels.append([])
        levels[depth[i]].append(i)
    return levels


def chain_entries(model):
    """M's chain entries ``[(d, j)]``, row by row, each row from its diagonal
    up the chain (d, lam[d], ...), and the start of each row's run."""
    lam, _ = dof_structure(model)
    entries, start = [], [0]
    for d in range(model.nv):
        entries += [(d, j) for j in _chain(lam, d)]
        start.append(len(entries))
    return entries, start


def ltdl_schedule(model):
    """The LTDL factor and solves as the kernel runs them.

    - ``block``: 6 when dofs 0..5 form a chain from the root (a root free
      joint): the kernel factors and solves that dense 6x6 block in
      registers, after every other dof and before them in the forward
      solve; else 0.
    - ``groups``: the other dofs by height in the dof tree (0 = no child
      dof), descending within a group; every descendant of a dof lies in an
      earlier group.
    - ``factor[g]``: ``[(target entry (i, j), [(entry (k, i), entry (k, j),
      k), ...])]`` for k in group g, descending: M[i][j] -= M[k][i] / D_k *
      M[k][j] over the strict ancestors i of k.
    - ``solve[g]``: ``[(j, [(entry (k, j), k), ...])]``: x[j] -= L[k][j] x[k].
    - ``depths``: the other dofs by depth (chain length - 1), for x[i] -=
      L[i][j] x[j] over the ancestors j, which come earlier.
    - ``order``: the order in which the factor finishes the rows.
    """
    lam, _ = dof_structure(model)
    nv = model.nv
    for k in range(nv):
        if not lam[k] < k:
            raise ValueError("dof chains must point to lower dof indices")
    block = 6 if nv >= 6 and all(int(lam[k]) == k - 1 for k in range(6)) else 0
    index = {pair: e for e, pair in enumerate(chain_entries(model)[0])}
    height = [0] * nv
    for k in reversed(range(nv)):
        if lam[k] >= 0:
            height[lam[k]] = max(height[lam[k]], height[k] + 1)
    rest = range(block, nv)
    depth = [len(_chain(lam, k)) - 1 for k in range(nv)]
    groups = [[k for k in reversed(rest) if height[k] == g]
              for g in range(max((height[k] for k in rest), default=-1) + 1)]
    factor, solve = [], []
    for group in groups:
        targets, rhs = {}, {}
        for k in group:
            for i in _chain(lam, k)[1:]:
                rhs.setdefault(i, []).append((index[(k, i)], k))
                for j in _chain(lam, i):
                    targets.setdefault(index[(i, j)], []).append((index[(k, i)], index[(k, j)], k))
        factor.append(list(targets.items()))
        solve.append(list(rhs.items()))
    depths = [[k for k in rest if depth[k] == D] for D in sorted({depth[k] for k in rest})]
    order = [k for group in groups for k in group] + list(reversed(range(block)))
    return {"block": block, "groups": groups, "factor": factor, "solve": solve,
            "depths": depths, "order": order}


def env_layout(nbody, nq, nv, ncon, nent):
    """Offsets (in floats) of each per-env array in shared memory, and the
    per-env float count."""
    sizes = (("qpos", nq), ("qvel", nv), ("anchor", 2 * ncon), ("gneg", 3),
             ("R", 9 * nbody), ("p", 3 * nbody), ("cols", 6 * nv), ("vel", 6 * nbody),
             ("mov", 6 * nbody), ("zeta", 6 * nbody), ("Ic", 13 * nbody), ("f", 6 * nbody),
             ("wc", 6 * ncon), ("M", nent), ("L", nent), ("x", nv), ("inv_d", nv))
    offsets, total = {}, 0
    for name, size in sizes:
        offsets[name] = total
        total += size
    return offsets, total


def block_shared_bytes(table_words, env_floats, lanes_per_env):
    """Dynamic shared memory of one block: the table, then one region per
    env of the block."""
    return 4 * (table_words + BLOCK_THREADS // lanes_per_env * env_floats)


def lanes_per_env(B):
    """Lanes that work on one env: 32 while a batch leaves the card's SMs
    short of warps (latency decides), 16 (two envs a warp, fewer
    instructions per env) once it fills them (instruction throughput
    decides); the two cross between the FastTD3 (1024) and PPO (4096)
    batches."""
    return 16 if B >= 2048 else 32


def check_model(model):
    """Raise if a block could not hold the model (before any table is
    built, with M's entry count at its most, nv (nv + 1) / 2)."""
    ncon = len(model.con_body)
    _, env_floats = env_layout(model.nbody, model.nq, model.nv, ncon, model.nv * (model.nv + 1) // 2)
    need = block_shared_bytes(0, env_floats, 16)
    if need > MAX_BLOCK_SHARED:
        raise ValueError(
            f"model nbody={model.nbody}, nq={model.nq}, nv={model.nv}, ncon={ncon} needs "
            f"{need} bytes of shared memory for {BLOCK_THREADS // 16} envs, over the "
            f"{MAX_BLOCK_SHARED} a block can have"
        )


# ------------------------------------------------------------------- tables


class KernelTables:
    """The flat 32-bit table (``words``: header scalars, section offsets,
    sections, zeros up to a multiple of 4 words for the kernel's 16-byte
    copy) and its per-env layout.  ``scalar`` and ``section`` read it back
    as the kernel does."""

    def __init__(self, words, used, kinds, env_floats):
        self.words = words
        self.used = used
        self.kinds = kinds
        self.env_floats = env_floats
        self.shared_bytes = block_shared_bytes(len(words), env_floats, 16)  # the larger

    def scalar(self, name):
        w = self.words[SCALARS.index(name): SCALARS.index(name) + 1]
        return float(w.view(np.float32)[0]) if name in _FLOAT_SCALARS else int(w[0])

    def section(self, name):
        t = SECTIONS.index(name)
        start = int(self.words[len(SCALARS) + t])
        end = int(self.words[len(SCALARS) + t + 1]) if t + 1 < len(SECTIONS) else self.used
        out = self.words[start:end]
        return out.view(np.float32) if self.kinds[name] == "f" else out


def _csr(lists):
    start = np.cumsum([0] + [len(x) for x in lists])
    flat = [v for x in lists for v in x]
    return start, flat


def model_tables(model, contact_timeconst, contact_dampratio, limit_stiffness):
    """The kernel's table for ``model`` (float64 host arithmetic rounded to
    float32, as the plain engine's Python floats)."""
    check_model(model)
    nbody, nv = model.nbody, model.nv
    nu, ncon = len(model.act_dof), len(model.con_body)
    lam, dof_body = dof_structure(model)
    dt = float(model.timestep)
    levels = body_levels(model)
    entries, ent_start = chain_entries(model)
    sched = ltdl_schedule(model)
    offsets, env_floats = env_layout(nbody, model.nq, nv, ncon, len(entries))

    ints, floats = {}, {}
    frame_rot = [quat_to_mat_np(q) for q in model.body_quat]
    ints["parent"] = model.parent
    ints["jnt_type"] = model.jnt_type
    ints["qpos_adr"] = model.qpos_adr
    ints["dof_adr"] = model.dof_adr
    ints["frame_identity"] = [np.allclose(C, np.eye(3)) for C in frame_rot]
    floats["frame_rot"] = frame_rot
    floats["body_pos"] = model.body_pos
    floats["icom_rot"] = [quat_to_mat_np(q) for q in model.body_iquat]
    floats["body_ipos"] = model.body_ipos
    floats["body_mass"] = model.body_mass
    floats["body_inertia"] = model.body_inertia
    floats["jnt_axis"] = model.jnt_axis
    floats["jnt_pos"] = model.jnt_pos
    ints["level_start"], ints["level_body"] = _csr(levels)
    children = [[c for c in reversed(range(nbody)) if int(model.parent[c]) == i] for i in range(nbody)]
    ints["child_start"], ints["child_list"] = _csr(children)
    ints["bcon_start"], ints["bcon_list"] = _csr(
        [[c for c in range(ncon) if int(model.con_body[c]) == i] for i in range(nbody)])

    ints["dof_body"] = dof_body
    floats["dof_armature"] = model.dof_armature
    floats["dof_damping"] = model.dof_damping
    floats["dof_frictionloss"] = model.dof_frictionloss
    limited, qadr, lo, hi, dlim = [0] * nv, [0] * nv, [0.0] * nv, [0.0] * nv, [0.0] * nv
    for i in range(nbody):
        if int(model.jnt_type[i]) == HINGE and bool(model.jnt_limited[i]):
            d = int(model.dof_adr[i])
            limited[d], qadr[d] = 1, int(model.qpos_adr[i])
            lo[d], hi[d] = (float(v) for v in model.jnt_range[i])
            dlim[d] = limit_damping(model, limit_stiffness, d)
    ints["dof_limited"], ints["dof_qadr"] = limited, qadr
    floats["dof_lo"], floats["dof_hi"], floats["dof_dlim"] = lo, hi, dlim
    ints["dact_start"], ints["dact_list"] = _csr(
        [[a for a in range(nu) if int(model.act_dof[a]) == d] for d in range(nv)])
    ints["ent_start"] = ent_start
    ints["ent_d"] = [d for d, _ in entries]
    ints["ent_j"] = [j for _, j in entries]

    ints["act_qpos"] = [int(model.qpos_adr[int(b)]) for b in model.act_joint_body]
    ints["act_is_position"] = model.act_is_position
    floats["act_kp"] = model.act_kp
    floats["act_kv"] = model.act_kv
    floats["act_gear"] = model.act_gear
    floats["act_lo"] = [float(r[0]) for r in model.act_forcerange]
    floats["act_hi"] = [float(r[1]) for r in model.act_forcerange]

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
    ints["con_body"] = model.con_body
    floats["con_pos"] = model.con_pos
    floats["con_radius"] = model.con_radius
    floats["con_friction"] = model.con_friction
    for n, values in con.items():
        floats["con_" + n] = values

    rows = [[(e, ent_start[k]) for k in group for e in range(ent_start[k], ent_start[k + 1])]
            for group in sched["groups"]]
    ints["grp_start"], rows = _csr(rows)
    ints["grp_ent"], ints["grp_diag"] = [e for e, _ in rows], [diag for _, diag in rows]
    ints["ftgt_start"], targets = _csr(sched["factor"])
    ints["ftgt_entry"] = [e for e, _ in targets]
    ints["ftgt_cstart"], contribs = _csr([c for _, c in targets])
    ints["fc_ki"], ints["fc_kj"] = ([c[n] for c in contribs] for n in range(2))
    ints["stgt_start"], rhs = _csr(sched["solve"])
    ints["stgt_dof"] = [j for j, _ in rhs]
    ints["stgt_cstart"], contribs = _csr([c for _, c in rhs])
    ints["sc_e"], ints["sc_i"] = ([c[n] for c in contribs] for n in range(2))
    ints["depth_start"], ints["depth_dof"] = _csr(sched["depths"])

    scalars = dict(
        nbody=nbody, nq=model.nq, nv=nv, nu=nu, ncon=ncon, nent=len(entries),
        free_block=int(sched["block"] > 0), nlevel=len(levels), ngroup=len(sched["groups"]), ndepth=len(sched["depths"]),
        env_floats=env_floats, timestep=dt, gravity_x=float(model.gravity[0]),
        gravity_y=float(model.gravity[1]), gravity_z=float(model.gravity[2]),
        omega_c=omega_c, limit_stiffness=limit_stiffness,
        **{"o_" + n: off for n, off in offsets.items()},
    )
    header = np.array([scalars[n] for n in SCALARS], dtype=np.float64)
    words = [np.array([np.float32(v).view(np.int32) if n in _FLOAT_SCALARS else int(v)
                       for n, v in zip(SCALARS, header)], dtype=np.int32)]
    words.append(np.zeros(len(SECTIONS), np.int32))
    kinds, pos = {}, len(SCALARS) + len(SECTIONS)
    for t, name in enumerate(SECTIONS):
        if name in ints:
            arr, kinds[name] = np.asarray(ints[name], dtype=np.int64).reshape(-1).astype(np.int32), "i"
        else:
            arr = np.asarray(floats[name], dtype=np.float64).reshape(-1).astype(np.float32).view(np.int32)
            kinds[name] = "f"
        words[1][t] = pos
        words.append(arr)
        pos += arr.size
    words.append(np.zeros(-pos % 4, np.int32))
    tables = KernelTables(np.concatenate(words), pos, kinds, env_floats)
    if tables.shared_bytes > MAX_BLOCK_SHARED:
        raise ValueError(f"the substep kernel needs {tables.shared_bytes} bytes of shared memory "
                         f"per block, over the {MAX_BLOCK_SHARED} a block can have")
    return tables


# ------------------------------------------------------------------- launch


def bind(lib):
    """Check the library's table header and launch shape against this
    module's, set the argument types, and return the launch function."""
    fn = lib.rlx_engine_substep
    if fn.argtypes is None:
        lib.rlx_engine_table_names.restype = ctypes.c_char_p
        names = lib.rlx_engine_table_names().decode()
        expected = ",".join(SCALARS) + ",|" + ",".join(SECTIONS) + ","
        if names != expected:
            raise RuntimeError(f"kernel table header {names!r} does not match the wrapper's {expected!r}")
        if lib.rlx_engine_block_threads() != BLOCK_THREADS:
            raise RuntimeError("kernel and wrapper disagree on BLOCK_THREADS")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rlx_engine_blocks_per_sm.argtypes = [I, I, I, P]
        fn.argtypes = [P, P, I, I, P, P, P, I, P, P, P, P, P, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def _lib():
    return bind(_build.load("engine_substep"))


def resident_warps_per_sm(model, lanes, contact_timeconst=0.015, contact_dampratio=1.0,
                          limit_stiffness=200.0):
    """Warps of the kernel one SM of the current device holds at once for
    ``model`` at ``lanes`` lanes per env (CUDA's occupancy calculator:
    registers, shared memory)."""
    tables = model_tables(model, contact_timeconst, contact_dampratio, limit_stiffness)
    _lib()
    blocks = ctypes.c_int()
    err = _build.load("engine_substep").rlx_engine_blocks_per_sm(
        len(tables.words), tables.env_floats, lanes, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"occupancy query failed (cudaError {err})")
    return blocks.value * BLOCK_THREADS // 32


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
    """Device tables per (model, device, contact and limit parameters),
    uploaded once."""

    def __init__(self):
        self._entries = {}

    def get(self, model, device, *params):
        key = (id(model), str(device)) + params
        entry = self._entries.get(key)
        if entry is None or entry[0] is not model:
            tables = model_tables(model, *params)
            entry = (model, tables, torch.as_tensor(tables.words, device=device))
            self._entries[key] = entry
        return entry[1], entry[2]


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
    tables, table = _tables.get(model, device, float(contact_timeconst),
                                float(contact_dampratio), float(limit_stiffness))

    qpos, qvel = qpos.contiguous(), qvel.contiguous()
    if ctrl_sequence is not None:
        if ctrl_sequence.shape[1:] != (B, nu):
            raise ValueError(f"ctrl_sequence must be [S, {B}, {nu}]")
        ctrl = ctrl_sequence.contiguous()
        nr_substeps, per_substep = ctrl_sequence.shape[0], 1
    else:
        if ctrl.shape != (B, nu):
            raise ValueError(f"ctrl must be [{B}, {nu}]")
        ctrl, per_substep = ctrl.contiguous(), 0
    anchors_in = anchors_out = None
    if contact_state is not None:
        if contact_state.shape != (B, ncon, 2):
            raise ValueError(f"contact_state must be [{B}, {ncon}, 2]")
        if ncon > 0:
            anchors_in = contact_state.contiguous()
            anchors_out = torch.empty_like(anchors_in)
    dr_fields = _dr_tensors(model, dr, B, device)
    dr_ptrs = (ctypes.c_void_p * len(dr_fields))(
        *[None if t is None else t.data_ptr() for t in dr_fields]
    )
    qpos_out = torch.empty_like(qpos)
    qvel_out = torch.empty_like(qvel)

    ptr = lambda t: None if t is None else t.data_ptr()
    err = _lib()(
        tables.words.ctypes.data, table.data_ptr(), table.numel(), lanes_per_env(B),
        ptr(qpos), ptr(qvel), ptr(ctrl), per_substep, ptr(anchors_in),
        ptr(qpos_out), ptr(qvel_out), ptr(anchors_out),
        ctypes.addressof(dr_ptrs), B, int(nr_substeps),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"substep kernel launch failed (cudaError {err})")
    step_cuda.launches += 1

    if contact_state is None:
        return qpos_out, qvel_out
    if ncon == 0:
        return qpos_out, qvel_out, torch.zeros((B, 0, 2), device=device)
    return qpos_out, qvel_out, anchors_out


step_cuda.launches = 0


# ---------------------------------------------------------------- roofline


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
