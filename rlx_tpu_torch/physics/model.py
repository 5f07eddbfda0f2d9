"""MJCF -> static ``PhysicsModel`` (numpy constants), plus a ``.npz`` form.

Compiling MJCF needs the MuJoCo C bindings, which are imported lazily inside
``load_mjcf``: a machine without ``mujoco`` loads a model that was compiled
elsewhere and saved with ``save_model`` (``load_model``).  The Ant ships
such a file (``environments/locomotion/ant/data/ant_model.npz``).

Supported subset (what locomotion RL models need; errors otherwise):
- joints: one free root joint and/or hinge joints
- geoms: sphere / capsule colliders against the ground plane
- actuators: 'position' servos (gainprm kp, biasprm kv) and 'motor' torque
- per-dof damping, armature, frictionloss; hinge joint limits
"""

from typing import NamedTuple, Optional

import numpy as np

FREE = 0
HINGE = 3  # mujoco.mjtJoint values: FREE=0, BALL=1, SLIDE=2, HINGE=3


class PhysicsModel(NamedTuple):
    # tree
    nbody: int                 # movable bodies (world excluded)
    nq: int
    nv: int
    parent: np.ndarray         # [nbody] index into movable bodies, -1 = world
    body_pos: np.ndarray       # [nbody, 3] frame offset in parent frame
    body_quat: np.ndarray      # [nbody, 4]
    # inertia (body frame)
    body_ipos: np.ndarray      # [nbody, 3] com offset
    body_iquat: np.ndarray     # [nbody, 4] principal-axes rotation
    body_mass: np.ndarray      # [nbody]
    body_inertia: np.ndarray   # [nbody, 3] principal moments
    # joints: at most one joint per body (free or hinge)
    jnt_type: np.ndarray       # [nbody] FREE / HINGE / -1 (fixed)
    jnt_axis: np.ndarray       # [nbody, 3] hinge axis in body frame
    jnt_pos: np.ndarray        # [nbody, 3] hinge anchor in body frame
    jnt_range: np.ndarray      # [nbody, 2] hinge limits (0, 0 = unlimited)
    jnt_limited: np.ndarray    # [nbody] bool
    qpos_adr: np.ndarray       # [nbody] start in qpos
    dof_adr: np.ndarray        # [nbody] start in qvel
    # dofs
    dof_damping: np.ndarray    # [nv]
    dof_armature: np.ndarray   # [nv]
    dof_frictionloss: np.ndarray  # [nv]
    # actuators (one per actuated hinge dof)
    act_dof: np.ndarray        # [nu] dof index
    act_joint_body: np.ndarray  # [nu] body whose hinge is actuated
    act_kp: np.ndarray         # [nu] position gain (0 for motor)
    act_kv: np.ndarray         # [nu] velocity gain
    act_gear: np.ndarray       # [nu]
    act_is_position: np.ndarray  # [nu] bool
    act_forcerange: np.ndarray  # [nu, 2]
    # contact points: capsule endpoints / sphere centers vs ground plane
    con_body: np.ndarray       # [ncon] body index
    con_pos: np.ndarray        # [ncon, 3] point in body frame
    con_radius: np.ndarray     # [ncon]
    con_friction: np.ndarray   # [ncon] tangential friction coefficient
    con_meff: np.ndarray       # [ncon] load-share mass for penalty-gain scaling
    con_m_app: np.ndarray      # [ncon] normal apparent mass 1/(J_z M^-1 J_z^T) at qpos0
    con_m_app_t: np.ndarray    # [ncon] tangential apparent mass (min over x/y)
    # geom table (all geoms incl. visual-only; env-side FK queries)
    geom_name: tuple           # [ngeom] static names ('' if unnamed)
    geom_body: np.ndarray      # [ngeom] movable-body index (-1 = world)
    geom_pos: np.ndarray       # [ngeom, 3] offset in body frame
    geom_size: np.ndarray      # [ngeom, 3]
    geom_group: np.ndarray     # [ngeom]
    # options
    timestep: float
    gravity: np.ndarray        # [3]
    qpos0: np.ndarray          # [nq] default pose (first keyframe or qpos0)


_SCALARS = {"nbody": int, "nq": int, "nv": int, "timestep": float}


def save_model(model: PhysicsModel, path: str) -> None:
    """Write every field of ``model`` to an ``.npz`` file (no pickles)."""
    arrays = {}
    for name in PhysicsModel._fields:
        value = getattr(model, name)
        if name == "geom_name":
            value = np.asarray(value, dtype=np.str_)
        arrays[name] = np.asarray(value)
    np.savez(path, **arrays)


def load_model(path: str) -> PhysicsModel:
    """Read a model written by ``save_model``."""
    with np.load(path, allow_pickle=False) as data:
        fields = {}
        for name in PhysicsModel._fields:
            value = data[name]
            if name in _SCALARS:
                value = _SCALARS[name](value)
            elif name == "geom_name":
                value = tuple(str(s) for s in value)
            else:
                value = np.array(value)
            fields[name] = value
    return PhysicsModel(**fields)


def load_mjcf(xml_path: Optional[str] = None, xml_string: Optional[str] = None,
              keyframe: Optional[str] = None) -> PhysicsModel:
    import mujoco

    if xml_string is not None:
        m = mujoco.MjModel.from_xml_string(xml_string)
    else:
        m = mujoco.MjModel.from_xml_path(xml_path)

    nbody = m.nbody - 1  # drop world body; movable body i = mujoco body i+1

    parent = np.asarray(m.body_parentid[1:], dtype=np.int32) - 1  # world -> -1

    jnt_type = np.full(nbody, -1, dtype=np.int32)
    jnt_axis = np.zeros((nbody, 3), dtype=np.float64)
    jnt_pos = np.zeros((nbody, 3), dtype=np.float64)
    jnt_range = np.zeros((nbody, 2), dtype=np.float64)
    jnt_limited = np.zeros(nbody, dtype=bool)
    qpos_adr = np.zeros(nbody, dtype=np.int32)
    dof_adr = np.zeros(nbody, dtype=np.int32)

    for j in range(m.njnt):
        body = m.jnt_bodyid[j] - 1
        jt = m.jnt_type[j]
        if jt == mujoco.mjtJoint.mjJNT_FREE:
            jnt_type[body] = FREE
        elif jt == mujoco.mjtJoint.mjJNT_HINGE:
            if jnt_type[body] != -1:
                raise NotImplementedError("multiple joints per body not supported")
            jnt_type[body] = HINGE
        else:
            raise NotImplementedError(f"joint type {jt} not supported (free/hinge only)")
        jnt_axis[body] = m.jnt_axis[j]
        jnt_pos[body] = m.jnt_pos[j]
        jnt_range[body] = m.jnt_range[j]
        jnt_limited[body] = bool(m.jnt_limited[j])
        qpos_adr[body] = m.jnt_qposadr[j]
        dof_adr[body] = m.jnt_dofadr[j]

    nu = m.nu
    act_dof = np.zeros(nu, dtype=np.int32)
    act_joint_body = np.zeros(nu, dtype=np.int32)
    act_kp = np.zeros(nu, dtype=np.float64)
    act_kv = np.zeros(nu, dtype=np.float64)
    act_gear = np.ones(nu, dtype=np.float64)
    act_is_position = np.zeros(nu, dtype=bool)
    act_forcerange = np.zeros((nu, 2), dtype=np.float64)
    for a in range(nu):
        if m.actuator_trntype[a] != mujoco.mjtTrn.mjTRN_JOINT:
            raise NotImplementedError("only joint-transmission actuators supported")
        j = m.actuator_trnid[a, 0]
        body = m.jnt_bodyid[j] - 1
        act_joint_body[a] = body
        act_dof[a] = m.jnt_dofadr[j]
        act_gear[a] = m.actuator_gear[a, 0]
        if m.actuator_biastype[a] == mujoco.mjtBias.mjBIAS_AFFINE:
            # position servo: gain kp, bias [0, -kp, -kv]
            act_is_position[a] = True
            act_kp[a] = m.actuator_gainprm[a, 0]
            act_kv[a] = -m.actuator_biasprm[a, 2]
        elif m.actuator_gaintype[a] != mujoco.mjtGain.mjGAIN_FIXED:
            raise NotImplementedError("unsupported actuator gain type")
        if m.actuator_forcelimited[a]:
            act_forcerange[a] = m.actuator_forcerange[a]
        else:
            act_forcerange[a] = (-np.inf, np.inf)

    # contacts: explicit pairs if present, else every sphere/capsule vs plane
    con_body, con_pos, con_radius, con_friction = [], [], [], []

    def add_geom_contacts(g):
        body = m.geom_bodyid[g] - 1
        if body < 0:
            return
        gtype = m.geom_type[g]
        size = m.geom_size[g]
        gpos = m.geom_pos[g]
        friction = m.geom_friction[g, 0]
        if gtype == mujoco.mjtGeom.mjGEOM_SPHERE:
            con_body.append(body)
            con_pos.append(gpos.copy())
            con_radius.append(size[0])
            con_friction.append(friction)
        elif gtype == mujoco.mjtGeom.mjGEOM_CAPSULE:
            # two endpoint spheres along local z, rotated into the body frame
            rot = np.zeros(9)
            mujoco.mju_quat2Mat(rot, m.geom_quat[g])
            axis = rot.reshape(3, 3)[:, 2]
            for sign in (-1.0, 1.0):
                con_body.append(body)
                con_pos.append(gpos + sign * size[1] * axis)
                con_radius.append(size[0])
                con_friction.append(friction)

    if m.npair > 0:
        plane_geoms = {g for g in range(m.ngeom) if m.geom_type[g] == mujoco.mjtGeom.mjGEOM_PLANE}
        for p in range(m.npair):
            g1, g2 = m.pair_geom1[p], m.pair_geom2[p]
            if g1 in plane_geoms:
                add_geom_contacts(g2)
            elif g2 in plane_geoms:
                add_geom_contacts(g1)
            else:
                raise NotImplementedError("only geom-plane contact pairs supported")
    else:
        for g in range(m.ngeom):
            if m.geom_contype[g] or m.geom_conaffinity[g]:
                add_geom_contacts(g)

    qpos0 = np.asarray(m.qpos0, dtype=np.float64).copy()
    if keyframe is not None:
        qpos0 = np.asarray(m.keyframe(keyframe).qpos, dtype=np.float64).copy()
    elif m.nkey > 0:
        qpos0 = np.asarray(m.key_qpos[0], dtype=np.float64).copy()

    # Apparent masses along the contact normal (world z) and the tangential
    # directions at the nominal pose, 1 / (J M^-1 J^T): the integrator
    # stability masses that cap the penalty gains (see engine).
    con_m_app, con_m_app_t = [], []
    if con_body:
        d0 = mujoco.MjData(m)
        d0.qpos[:] = qpos0
        mujoco.mj_forward(m, d0)
        for c in range(len(con_body)):
            bid = int(con_body[c]) + 1
            point = d0.xpos[bid] + d0.xmat[bid].reshape(3, 3) @ np.asarray(con_pos[c])
            jacp = np.zeros((3, m.nv))
            mujoco.mj_jac(m, d0, jacp, None, point, bid)
            jacp = np.ascontiguousarray(jacp)
            minv_jac = np.zeros_like(jacp)
            mujoco.mj_solveM(m, d0, minv_jac, jacp)
            inv_masses = [max(float(jacp[k] @ minv_jac[k]), 1e-9) for k in range(3)]
            con_m_app.append(1.0 / inv_masses[2])
            con_m_app_t.append(1.0 / max(inv_masses[0], inv_masses[1]))

    f32 = lambda x: np.asarray(x, dtype=np.float32)
    con_body_arr = np.asarray(con_body, dtype=np.int32)
    return PhysicsModel(
        nbody=nbody,
        nq=m.nq,
        nv=m.nv,
        parent=parent,
        body_pos=f32(m.body_pos[1:]),
        body_quat=f32(m.body_quat[1:]),
        body_ipos=f32(m.body_ipos[1:]),
        body_iquat=f32(m.body_iquat[1:]),
        body_mass=f32(m.body_mass[1:]),
        body_inertia=f32(m.body_inertia[1:]),
        jnt_type=jnt_type,
        jnt_axis=f32(jnt_axis),
        jnt_pos=f32(jnt_pos),
        jnt_range=f32(jnt_range),
        jnt_limited=jnt_limited,
        qpos_adr=qpos_adr,
        dof_adr=dof_adr,
        dof_damping=f32(m.dof_damping),
        dof_armature=f32(m.dof_armature),
        dof_frictionloss=f32(m.dof_frictionloss),
        act_dof=act_dof,
        act_joint_body=act_joint_body,
        act_kp=f32(act_kp),
        act_kv=f32(act_kv),
        act_gear=f32(act_gear),
        act_is_position=act_is_position,
        act_forcerange=f32(act_forcerange),
        con_body=con_body_arr,
        con_pos=f32(np.asarray(con_pos).reshape(-1, 3)),
        con_radius=f32(con_radius),
        con_friction=f32(con_friction),
        # the larger of the contact body's own mass and an even share of the
        # total mass across contacts (sets the penalty gains)
        con_meff=f32(
            np.maximum(
                np.asarray(m.body_mass[1:])[con_body_arr],
                m.body_mass[1:].sum() / max(len(con_body), 1),
            )
            if con_body
            else np.zeros(0)
        ),
        con_m_app=f32(con_m_app),
        con_m_app_t=f32(con_m_app_t),
        geom_name=tuple(
            (mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_GEOM, g) or "") for g in range(m.ngeom)
        ),
        geom_body=np.asarray(m.geom_bodyid, dtype=np.int32) - 1,
        geom_pos=f32(m.geom_pos),
        geom_size=f32(m.geom_size),
        geom_group=np.asarray(m.geom_group, dtype=np.int32),
        timestep=float(m.opt.timestep),
        gravity=f32(m.opt.gravity),
        qpos0=f32(qpos0),
    )
