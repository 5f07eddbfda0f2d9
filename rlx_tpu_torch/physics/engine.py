"""Batched forward dynamics + integrator (PyTorch, batch-last layout).

Per substep:

1. forward kinematics (python loop over the static tree, parents first);
2. world Jacobian columns per dof: hinge ``[a; x_anchor x a]``, free joint
   ``[0; e_k]`` + ``[a_k; p x a_k]`` with MuJoCo's free-joint convention
   (linear velocity world, angular velocity body-local);
3. mass matrix via CRBA over the static tree (composite world inertias,
   M[d, j] = S_j^T I^C_{body(d)} S_d for (dof, ancestor-dof) pairs only,
   plus armature on the diagonal);
4. bias forces via the velocity-product recursion with gravity folded in as
   the base acceleration, projected onto the dofs by one RNEA-style
   backward accumulation of world wrenches up the tree;
5. penalty contacts (sphere/capsule-endpoint vs the plane z=0 or a per-env
   heightfield, ``Terrain``) with stick-slip anchors for tangential friction;
6. actuators (position servo or motor), damping, smooth frictionloss, damped
   joint-limit springs;
7. qacc by the tree-sparse LTDL solve; semi-implicit Euler with quaternion
   integration for the free joint.

All internal state is ``[comp..., B]``.  The public API is batch-first:
qpos [B, nq], qvel [B, nv], ctrl [B, nu].

``step`` dispatches on the device of its inputs: a CUDA tensor on the plane
goes through the hand-written substep kernel
(``rlx_tpu_torch.ops.engine_substep_cuda``), a CPU tensor through
``step_reference``, the eager path in this file, which is the kernel's plain
version.  A step over a heightfield runs ``step_reference`` on whatever
device its tensors are on: the kernel covers the plane only, as the JAX
package's substep kernel does (its ``engine.step`` sends terrain to XLA).

The model's constants (frame rotations, offsets, axes, inertias, gravity,
armature, damping, frictionloss) are uploaded once per model and device
(``constants``): after a model's first call on a device, no function here
makes a tensor from host data, so a CUDA graph can capture the eager path.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from rlx_tpu_torch.physics import batched as bl
from rlx_tpu_torch.physics.model import FREE, HINGE, PhysicsModel


class DomainParams(NamedTuple):
    """Per-env runtime physics randomization (batch-last, ``[..., B]``).
    Every field is optional; ``None`` means "use the compiled constant"."""

    mass_scale: Optional[torch.Tensor] = None          # [nbody, B] inertia+mass
    damping_scale: Optional[torch.Tensor] = None       # [B] or [nv, B] joint damping
    frictionloss_scale: Optional[torch.Tensor] = None  # [B] dry friction
    armature_scale: Optional[torch.Tensor] = None      # [B] rotor armature
    friction_scale: Optional[torch.Tensor] = None      # [B] contact friction mu
    contact_stiffness_scale: Optional[torch.Tensor] = None  # [B] penalty omega
    kp_scale: Optional[torch.Tensor] = None            # [nu, B] P gain
    kv_scale: Optional[torch.Tensor] = None            # [nu, B] D gain
    forcerange_scale: Optional[torch.Tensor] = None    # [nu, B] torque limit
    ctrl_offset: Optional[torch.Tensor] = None         # [nu, B] servo zero shift
    gravity: Optional[torch.Tensor] = None             # [3, B] gravity vector


class Terrain(NamedTuple):
    """Per-env square heightfield for ground contact (batch-last).

    ``height`` is ``[n*n, B]`` (row-major ``[iy, ix]``), covering x, y in
    ``[-half_extent_m, half_extent_m]``; lookups take the nearest cell.
    ``None`` terrain is the plane z=0."""

    height: torch.Tensor
    n: int
    half_extent_m: float


def terrain_height_T(terrain: Terrain, x, y):
    """Nearest-cell terrain height at world (x, y); inputs and output
    ``[..., B]``.  Rounding is half to even, as ``jnp.round``."""
    n = terrain.n
    cells_per_m = n / (2.0 * terrain.half_extent_m)
    ix = torch.clamp(torch.round(x * cells_per_m + n // 2).to(torch.int64), 0, n - 1)
    iy = torch.clamp(torch.round(y * cells_per_m + n // 2).to(torch.int64), 0, n - 1)
    flat = (iy * n + ix).reshape(-1, x.shape[-1])                 # [K, B]
    return torch.gather(terrain.height, 0, flat).reshape(x.shape)


def quat_to_mat_np(q):
    """Constant quaternion (w, x, y, z) -> float32 rotation matrix."""
    w, x, y, z = (float(c) for c in q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float32,
    )


def dof_structure(model: PhysicsModel):
    """Static dof-tree structure:

    - ``lam[d]``: the preceding dof on d's kinematic chain (-1 at the root);
      within a free joint the 6 dofs chain linearly; the first dof of a
      joint chains to the last dof of the nearest jointed ancestor body;
    - ``dof_body[d]``: the body the dof belongs to.
    """
    lam = np.full(model.nv, -1, dtype=np.int64)
    dof_body = np.zeros(model.nv, dtype=np.int64)
    last_dof = np.full(model.nbody, -1, dtype=np.int64)
    for i in range(model.nbody):
        par = int(model.parent[i])
        prev = int(last_dof[par]) if par != -1 else -1
        jt = int(model.jnt_type[i])
        d = int(model.dof_adr[i])
        if jt == FREE:
            for k in range(6):
                lam[d + k] = prev
                dof_body[d + k] = i
                prev = d + k
            last_dof[i] = d + 5
        elif jt == HINGE:
            lam[d] = prev
            dof_body[d] = i
            last_dof[i] = d
        else:
            last_dof[i] = prev  # jointless body: chain passes through
    return lam, dof_body


class _Constants:
    """A model's constants as float32 tensors on one device, each made as
    the eager path used to make it at every call (the same values, so the
    same results), and the dof tree's structure."""

    def __init__(self, model: PhysicsModel, device):
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.lam, self.dof_body = dof_structure(model)
        # each body's frame rotation, None where it is the identity
        self.frame_rot = [None if np.allclose(C, np.eye(3)) else f32(C)
                          for C in (quat_to_mat_np(q) for q in model.body_quat)]
        self.body_pos = [f32(x) for x in model.body_pos]
        self.jnt_pos = [f32(x) for x in model.jnt_pos]
        self.jnt_axis = [f32(x) for x in model.jnt_axis]
        self.rodrigues = {i: tuple(f32(x) for x in bl.rodrigues_matrices(model.jnt_axis[i]))
                          for i in range(model.nbody) if int(model.jnt_type[i]) == HINGE}
        self.icom_rot = [f32(quat_to_mat_np(q)) for q in model.body_iquat]
        self.body_inertia = [f32(x) for x in model.body_inertia]
        self.body_ipos = [f32(x) for x in model.body_ipos]
        self.con_pos = [f32(x) for x in model.con_pos]
        self.neg_gravity = f32(-np.asarray(model.gravity, np.float32))
        self.armature = f32(np.diag(model.dof_armature).astype(np.float32))[:, :, None]
        self.damping = f32(model.dof_damping)[:, None]
        self.frictionloss = f32(model.dof_frictionloss)[:, None]


class PerModelCache:
    """``make(model, device, *params)``, made once per model, device and
    ``params`` and kept for the process: keyed on ``id(model)``, with the
    model kept to guard the id (a model changed by ``_replace``, e.g. another
    timestep, is a new object with its own entry)."""

    def __init__(self, make):
        self.make = make
        self.entries = {}

    def __call__(self, model: PhysicsModel, device, *params):
        key = (id(model), str(device), *params)
        entry = self.entries.get(key)
        if entry is None or entry[0] is not model:
            entry = self.entries[key] = (model, self.make(model, device, *params))
        return entry[1]


# the model's constant tensors on a device, uploaded on the first call for
# that model and device
constants = PerModelCache(_Constants)


def _kinematics_T(model: PhysicsModel, qposT):
    """FK: qposT [nq, B] -> (Rs, ps) lists of ([3, 3, B], [3, B]) per body."""
    B = qposT.shape[-1]
    dev = qposT.device
    k = constants(model, dev)
    Rs, ps = [], []
    eye = torch.eye(3, device=dev)[:, :, None].expand(3, 3, B)
    zero3 = torch.zeros((3, B), device=dev)
    hinge_bodies = [i for i in range(model.nbody) if int(model.jnt_type[i]) == HINGE]
    trig = {}
    if hinge_bodies:
        angles = torch.stack([qposT[int(model.qpos_adr[i])] for i in hinge_bodies])
        sins, coss = torch.sin(angles), torch.cos(angles)
        trig = {i: (sins[k], coss[k]) for k, i in enumerate(hinge_bodies)}
    for i in range(model.nbody):
        par = int(model.parent[i])
        Rp, pp = (Rs[par], ps[par]) if par != -1 else (eye, zero3)
        C = k.frame_rot[i]
        R_frame = Rp if C is None else bl.matmul_const(Rp, C)
        p_frame = pp + bl.matvec_const(Rp, k.body_pos[i])
        jt = int(model.jnt_type[i])
        if jt == FREE:
            qa = int(model.qpos_adr[i])
            p = qposT[qa: qa + 3]
            R = bl.quat_to_rot(qposT[qa + 3: qa + 7])
        elif jt == HINGE:
            s, c = trig[i]
            R_axis = bl.rodrigues_sc(k.rodrigues[i], s, c)
            R = bl.matmul(R_frame, R_axis)
            p = p_frame + bl.matvec_const(R_frame - R, k.jnt_pos[i])
        else:
            R, p = R_frame, p_frame
        Rs.append(R)
        ps.append(p)
    return Rs, ps


def _jacobian_columns_T(model: PhysicsModel, Rs, ps):
    """[nv, 6, B] world-origin Plücker columns."""
    B = ps[0].shape[-1]
    dev = ps[0].device
    k = constants(model, dev)
    cols = [None] * model.nv
    zeros = torch.zeros((3, B), device=dev)
    for i in range(model.nbody):
        jt = int(model.jnt_type[i])
        d = int(model.dof_adr[i])
        if jt == FREE:
            for j in range(3):  # linear dofs, world axes
                e = zeros.clone()
                e[j].fill_(1.0)
                cols[d + j] = torch.cat([zeros, e])
            for j in range(3):  # angular dofs, body-local axes
                a = Rs[i][:, j]
                cols[d + 3 + j] = torch.cat([a, bl.cross(ps[i], a)])
        elif jt == HINGE:
            a = bl.matvec_const(Rs[i], k.jnt_axis[i])
            anchor = ps[i] + bl.matvec_const(Rs[i], k.jnt_pos[i])
            cols[d] = torch.cat([a, bl.cross(anchor, a)])
    if model.nv == 0:
        return torch.zeros((0, 6, B), device=dev)
    return torch.stack(cols)


def _spatial_inertia_T(model: PhysicsModel, k: _Constants, i, R, p):
    """[6, 6, B] world-origin spatial inertia of body i (``k``: the model's
    constants on R's device)."""
    R_icom = bl.matmul_const(R, k.icom_rot[i])
    scaled = R_icom * k.body_inertia[i][None, :, None]
    I_c = bl.matmul(scaled, bl.transpose(R_icom))
    com = p + bl.matvec_const(R, k.body_ipos[i])
    c = bl.skew(com)
    m = float(model.body_mass[i])
    top_left = I_c + m * bl.matmul(c, bl.transpose(c))
    top_right = m * c
    bottom_left = m * bl.transpose(c)
    eyeB = torch.eye(3, device=R.device)[:, :, None].expand(c.shape)
    bottom_right = m * eyeB
    top = torch.cat([top_left, top_right], dim=1)
    bottom = torch.cat([bottom_left, bottom_right], dim=1)
    return torch.cat([top, bottom], dim=0)


def _crba_M_T(model: PhysicsModel, cols, I_list, lam, dof_body):
    """Composite-rigid-body mass matrix [nv, nv, B] (excl. armature)."""
    B = cols.shape[-1]
    Ic = list(I_list)
    for i in range(model.nbody - 1, 0, -1):
        par = int(model.parent[i])
        if par != -1:
            Ic[par] = Ic[par] + Ic[i]
    entries = {}
    for d in range(model.nv):
        F = bl.matvec(Ic[int(dof_body[d])], cols[d])      # [6, B]
        j = d
        while j != -1:
            entries[(d, j)] = (cols[j] * F).sum(0)        # [B]
            j = int(lam[j])
    M = torch.zeros((model.nv, model.nv, B), device=cols.device)
    for (i, j), e in entries.items():
        M[i, j] = e
        M[j, i] = e
    return M


def _backward_project_T(model: PhysicsModel, cols, f_list, dof_body):
    """RNEA-style backward pass: accumulate per-body world wrenches up the
    tree, then project onto each dof's own axis -> [nv, B]."""
    f_tot = list(f_list)
    for i in range(model.nbody - 1, 0, -1):
        par = int(model.parent[i])
        if par != -1:
            f_tot[par] = f_tot[par] + f_tot[i]
    if model.nv == 0:
        return torch.zeros((0, cols.shape[-1]), device=cols.device)
    return torch.stack(
        [(cols[d] * f_tot[int(dof_body[d])]).sum(0) for d in range(model.nv)]
    )


def _dynamics_T(model: PhysicsModel, qposT, qvelT, dr: Optional[DomainParams] = None):
    """Returns (M [nv, nv, B] incl. armature, per-body [6, B] world bias
    wrenches, Rs, ps, v list, cols)."""
    B = qposT.shape[-1]
    dev = qposT.device
    k = constants(model, dev)
    lam, dof_body = k.lam, k.dof_body
    Rs, ps = _kinematics_T(model, qposT)
    cols = _jacobian_columns_T(model, Rs, ps)  # [nv, 6, B]

    if dr is not None and dr.gravity is not None:
        zeta0 = torch.cat([torch.zeros((3, B), device=dev), -dr.gravity])
    else:
        zeta0 = torch.cat([torch.zeros((3, B), device=dev), k.neg_gravity[:, None].expand(3, B)])

    v_list = [None] * model.nbody
    zeta_list = [None] * model.nbody
    I_list = [None] * model.nbody
    f_bias = [None] * model.nbody
    zero6 = torch.zeros((6, B), device=dev)

    for i in range(model.nbody):
        par = int(model.parent[i])
        v_par = v_list[par] if par != -1 else zero6
        z_par = zeta_list[par] if par != -1 else zeta0
        jt = int(model.jnt_type[i])
        d = int(model.dof_adr[i])
        if jt == FREE:
            own = (cols[d: d + 6] * qvelT[d: d + 6, None, :]).sum(0)
            own_moving = (cols[d + 3: d + 6] * qvelT[d + 3: d + 6, None, :]).sum(0)
        elif jt == HINGE:
            own = cols[d] * qvelT[d][None]
            own_moving = own
        else:
            own = own_moving = zero6
        v_i = v_par + own
        zeta_i = z_par + bl.cross_motion(v_i, own_moving)
        v_list[i] = v_i
        zeta_list[i] = zeta_i

        I_w = _spatial_inertia_T(model, k, i, Rs[i], ps[i])  # [6, 6, B]
        if dr is not None and dr.mass_scale is not None:
            I_w = I_w * dr.mass_scale[i]
        I_list[i] = I_w

        Iv = bl.matvec(I_w, v_i)
        f_bias[i] = bl.matvec(I_w, zeta_i) + bl.cross_force(v_i, Iv)

    M = _crba_M_T(model, cols, I_list, lam, dof_body)
    armature = k.armature
    if dr is not None and dr.armature_scale is not None:
        armature = armature * dr.armature_scale
    M = M + armature
    return M, f_bias, Rs, ps, v_list, cols


def mass_matrix_bias(model: PhysicsModel, qpos, qvel):
    """Diagnostics/testing API: (M [B, nv, nv] incl. armature, C [B, nv])."""
    M, f_bias, Rs, ps, v_list, cols = _dynamics_T(model, qpos.T, qvel.T)
    _, dof_body = dof_structure(model)
    C = _backward_project_T(model, cols, f_bias, dof_body)
    return M.permute(2, 0, 1), C.T


def contact_points_T(model, qposT):
    """World xy of every engine contact point, [ncon, 2, B] (anchor init)."""
    if len(model.con_body) == 0:
        return torch.zeros((0, 2, qposT.shape[-1]), device=qposT.device)
    Rs, ps = _kinematics_T(model, qposT)
    k = constants(model, qposT.device)
    points = []
    for c in range(len(model.con_body)):
        b = int(model.con_body[c])
        x = ps[b] + bl.matvec_const(Rs[b], k.con_pos[c])
        points.append(x[:2])
    return torch.stack(points)


def contact_anchor_init(model, qpos):
    """Batch-first [B, ncon, 2] stick-friction anchors for ``qpos`` [B, nq]."""
    return contact_points_T(model, qpos.T).permute(2, 0, 1)


def _contact_wrenches_T(model, Rs, ps, v_list, contact_timeconst, contact_dampratio,
                        dr: Optional[DomainParams], anchorsT, terrain: Optional[Terrain] = None):
    """Per-body world contact wrenches (None where no contact touches the
    body) from penalty ground contacts on the plane z=0 or the heightfield
    ``terrain`` (the normal stays vertical), plus the updated
    stick-friction anchors.  Tangential friction holds a contact point by a
    spring to where it first touched while inside the friction cone; beyond
    the cone the anchor slides to the cone boundary."""
    wrenches = [None] * model.nbody
    k = constants(model, ps[0].device)
    omega_c = 1.0 / contact_timeconst
    if dr is not None and dr.contact_stiffness_scale is not None:
        omega_c = omega_c * dr.contact_stiffness_scale
    dt = float(model.timestep)
    new_anchors = []
    for c in range(len(model.con_body)):
        b = int(model.con_body[c])
        m_eff = float(model.con_meff[c])
        m_app = float(model.con_m_app[c]) if len(model.con_m_app) else m_eff
        # gains capped at the explicit-integration stability bound of the
        # contact's apparent mass
        stiffness = _minimum(m_eff * omega_c ** 2, 2.0 * m_app / dt ** 2)
        damping = _minimum(2.0 * contact_dampratio * m_eff * omega_c, 0.7 * m_app / dt)
        x = ps[b] + bl.matvec_const(Rs[b], k.con_pos[c])  # [3, B]
        ground = terrain_height_T(terrain, x[0], x[1]) if terrain is not None else 0.0
        depth = float(model.con_radius[c]) - (x[2] - ground)
        in_contact = depth > 0.0
        omega, v_o = v_list[b][:3], v_list[b][3:]
        v_pt = v_o + bl.cross(omega, x)
        fn = torch.where(in_contact, stiffness * depth - damping * v_pt[2], 0.0)
        fn = torch.clamp(fn, min=0.0)
        mu = float(model.con_friction[c])
        if dr is not None and dr.friction_scale is not None:
            mu = mu * dr.friction_scale
        f_max = mu * fn

        m_app_t = float(model.con_m_app_t[c]) if len(model.con_m_app_t) else m_app
        kt = 0.3 * m_app_t / dt ** 2
        ct = 0.4 * m_app_t / dt
        anchor = anchorsT[c]                                      # [2, B]
        anchor = torch.where(in_contact[None], anchor, x[:2])     # track while free
        disp = x[:2] - anchor
        ft_raw = -(kt * disp + ct * v_pt[:2])                     # [2, B]
        ft_norm = torch.sqrt(ft_raw[0] ** 2 + ft_raw[1] ** 2)
        cone = torch.clamp(f_max / (ft_norm + 1e-9), max=1.0)
        ft = ft_raw * cone
        disp_norm = torch.sqrt(disp[0] ** 2 + disp[1] ** 2)
        max_disp = f_max / kt
        disp_clamped = disp * torch.clamp(max_disp / (disp_norm + 1e-9), max=1.0)
        anchor = torch.where(in_contact[None], x[:2] - disp_clamped, x[:2])
        new_anchors.append(anchor)

        f = torch.stack([ft[0], ft[1], fn])                       # [3, B]
        F = torch.cat([bl.cross(x, f), f])                        # [6, B]
        wrenches[b] = F if wrenches[b] is None else wrenches[b] + F
    return wrenches, torch.stack(new_anchors)


def _minimum(a, b):
    """min of a python float and a python float or [B] tensor."""
    if isinstance(a, torch.Tensor):
        return torch.clamp(a, max=b)
    return min(a, b)


def actuator_forces_T(model, qposT, qvelT, ctrlT, dr: Optional[DomainParams] = None):
    """Per-actuator joint forces [nu, B] (clip(kp de - kv qd) or motor torque)."""
    if len(model.act_dof) == 0:
        return torch.zeros((0, qposT.shape[-1]), device=qposT.device)
    forces = []
    for a in range(len(model.act_dof)):
        d = int(model.act_dof[a])
        qa = int(model.qpos_adr[int(model.act_joint_body[a])])
        gear = float(model.act_gear[a])
        if bool(model.act_is_position[a]):
            kp = float(model.act_kp[a])
            kv = float(model.act_kv[a])
            if dr is not None and dr.kp_scale is not None:
                kp = kp * dr.kp_scale[a]
            if dr is not None and dr.kv_scale is not None:
                kv = kv * dr.kv_scale[a]
            target = ctrlT[a]
            if dr is not None and dr.ctrl_offset is not None:
                target = target + dr.ctrl_offset[a]
            force = kp * (target - qposT[qa]) - kv * qvelT[d]
        else:
            force = ctrlT[a] * gear
        lo, hi = (float(v) for v in model.act_forcerange[a])
        if dr is not None and dr.forcerange_scale is not None:
            lo, hi = lo * dr.forcerange_scale[a], hi * dr.forcerange_scale[a]
            force = torch.minimum(torch.maximum(force, lo), hi)
        else:
            force = torch.clamp(force, lo, hi)
        forces.append(force)
    return torch.stack(forces)


def limit_damping(model, limit_stiffness, d):
    """Damping of the joint-limit spring of dof ``d``: 2 sqrt(k I_arm),
    capped at the armature's explicit-integration bound 0.7 I_arm / dt
    (host float64, as ``np.sqrt``)."""
    i_arm = float(model.dof_armature[d])
    return min(2.0 * np.sqrt(limit_stiffness * i_arm), 0.7 * i_arm / float(model.timestep))


def _forward_dynamics_T(model, qposT, qvelT, ctrlT, contact_timeconst, contact_dampratio,
                        limit_stiffness, dr=None, anchorsT=None, terrain=None, include_contacts=True):
    M, f_net, Rs, ps, v_list, cols = _dynamics_T(model, qposT, qvelT, dr)
    k = constants(model, qposT.device)
    lam, dof_body = k.lam, k.dof_body

    if include_contacts and len(model.con_body) > 0:
        if anchorsT is None:
            anchorsT = contact_points_T(model, qposT)
        wrenches, anchorsT = _contact_wrenches_T(
            model, Rs, ps, v_list, contact_timeconst, contact_dampratio, dr, anchorsT, terrain,
        )
        f_net = [fb if w is None else fb - w for fb, w in zip(f_net, wrenches)]
    C = _backward_project_T(model, cols, f_net, dof_body)
    tau = torch.zeros_like(C)

    act_force = actuator_forces_T(model, qposT, qvelT, ctrlT, dr)
    for a in range(len(model.act_dof)):
        d = int(model.act_dof[a])
        gear = float(model.act_gear[a])
        tau[d] = tau[d] + act_force[a] * (gear if bool(model.act_is_position[a]) else 1.0)

    damping, frictionloss = k.damping, k.frictionloss
    if dr is not None and dr.damping_scale is not None:
        damping = damping * dr.damping_scale
    if dr is not None and dr.frictionloss_scale is not None:
        frictionloss = frictionloss * dr.frictionloss_scale
    tau = tau - damping * qvelT
    tau = tau - frictionloss * torch.tanh(qvelT / 0.05)
    for i in range(model.nbody):
        if int(model.jnt_type[i]) == HINGE and bool(model.jnt_limited[i]):
            qa, d = int(model.qpos_adr[i]), int(model.dof_adr[i])
            lo, hi = (float(v) for v in model.jnt_range[i])
            over_hi = torch.clamp(qposT[qa] - hi, min=0.0)
            under_lo = torch.clamp(lo - qposT[qa], min=0.0)
            d_lim = limit_damping(model, limit_stiffness, d)
            engaged = (over_hi > 0.0) | (under_lo > 0.0)
            tau[d] = tau[d] + (
                limit_stiffness * (under_lo - over_hi)
                - torch.where(engaged, d_lim * qvelT[d], 0.0)
            )

    return bl.ltdl_solve(M, tau - C, lam), anchorsT


def forward_dynamics(model: PhysicsModel, qpos, qvel, ctrl, contact_timeconst=0.015, contact_dampratio=1.0,
                     limit_stiffness=200.0, include_contacts=True, dr=None, terrain=None):
    """Batched joint accelerations ``qacc [B, nv]`` at one state (the JAX
    package's public ``forward_dynamics``): batch-first over the batch-last
    internals, the contact anchors at the entry pose, no contact forces
    without ``include_contacts``.  Returns ``(qacc, None)``, as JAX's."""
    qaccT, _ = _forward_dynamics_T(model, qpos.T, qvel.T, ctrl.T, contact_timeconst, contact_dampratio,
                                   limit_stiffness, dr, None, terrain, include_contacts)
    return qaccT.T.contiguous(), None


def _integrate_T(model, qposT, qvelT, qaccT, dt):
    """Semi-implicit Euler in batch-last layout."""
    qvel_new = qvelT + dt * qaccT
    qpos_new = qposT.clone()
    for i in range(model.nbody):
        jt = int(model.jnt_type[i])
        qa, d = int(model.qpos_adr[i]), int(model.dof_adr[i])
        if jt == FREE:
            qpos_new[qa: qa + 3] = qpos_new[qa: qa + 3] + dt * qvel_new[d: d + 3]
            qpos_new[qa + 3: qa + 7] = bl.quat_integrate(
                qposT[qa + 3: qa + 7], qvel_new[d + 3: d + 6], dt
            )
        elif jt == HINGE:
            qpos_new[qa] = qpos_new[qa] + dt * qvel_new[d]
    return qpos_new, qvel_new


def step(model: PhysicsModel, qpos, qvel, ctrl, nr_substeps=1,
         contact_timeconst=0.015, contact_dampratio=1.0, limit_stiffness=200.0,
         dr=None, terrain=None, ctrl_sequence=None, contact_state=None):
    """Advance ``nr_substeps`` timesteps of ``model.timestep`` each.

    ``ctrl_sequence`` (optional, [nr_substeps, B, nu]) supplies a different
    control per substep; otherwise ``ctrl`` [B, nu] is held for all substeps.

    ``contact_state`` (optional, [B, ncon, 2]): stick-friction anchors
    carried across control steps (see ``contact_anchor_init``).  When given,
    the return is ``(qpos, qvel, new_contact_state)``; when None, anchors are
    initialized from the entry pose and the return is ``(qpos, qvel)``.

    ``terrain`` (optional ``Terrain``): per-env heightfield ground.

    CUDA tensors on the plane go through the substep kernel, CPU tensors
    through ``step_reference``.  A step with ``terrain`` runs
    ``step_reference`` on the device of its tensors, the card included: the
    kernel covers the plane only, as the JAX package's does.
    """
    args = dict(
        nr_substeps=nr_substeps, contact_timeconst=contact_timeconst,
        contact_dampratio=contact_dampratio, limit_stiffness=limit_stiffness,
        dr=dr, ctrl_sequence=ctrl_sequence, contact_state=contact_state,
    )
    if terrain is not None:
        return step_reference(model, qpos, qvel, ctrl, terrain=terrain, **args)
    if qpos.is_cuda:
        from rlx_tpu_torch.ops.engine_substep_cuda import step_cuda

        return step_cuda(model, qpos, qvel, ctrl, **args)
    return step_reference(model, qpos, qvel, ctrl, **args)


def step_reference(model: PhysicsModel, qpos, qvel, ctrl, nr_substeps=1,
                   contact_timeconst=0.015, contact_dampratio=1.0, limit_stiffness=200.0,
                   dr=None, terrain=None, ctrl_sequence=None, contact_state=None):
    """Eager PyTorch substeps on any device: the plain version of the
    substep kernel, and the path of every step over a heightfield.  Same
    signature and returns as ``step``."""
    dt = model.timestep
    if ctrl_sequence is not None:
        xs = ctrl_sequence.transpose(1, 2)  # [nr_substeps, nu, B]
    else:
        xs = ctrl.T[None].expand((nr_substeps,) + ctrl.T.shape)
    if contact_state is not None:
        anchorsT = contact_state.permute(1, 2, 0)  # [ncon, 2, B]
    else:
        anchorsT = contact_points_T(model, qpos.T)
    qposT, qvelT = qpos.T, qvel.T
    for s in range(xs.shape[0]):
        qaccT, anchorsT = _forward_dynamics_T(
            model, qposT, qvelT, xs[s], contact_timeconst, contact_dampratio,
            limit_stiffness, dr, anchorsT, terrain,
        )
        qposT, qvelT = _integrate_T(model, qposT, qvelT, qaccT, dt)
    if contact_state is not None:
        return qposT.T.contiguous(), qvelT.T.contiguous(), anchorsT.permute(2, 0, 1).contiguous()
    return qposT.T.contiguous(), qvelT.T.contiguous()


def kinematics(model: PhysicsModel, qpos):
    """Batched FK -> (R [B, nbody, 3, 3], p [B, nbody, 3]) (diagnostics API)."""
    Rs, ps = _kinematics_T(model, qpos.T)
    R = torch.stack([r.permute(2, 0, 1) for r in Rs], dim=1)
    p = torch.stack([r.T for r in ps], dim=1)
    return R, p
