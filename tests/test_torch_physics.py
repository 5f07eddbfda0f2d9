"""The port's physics (rlx_tpu_torch.physics) against the JAX engine.

Same seeded numpy states go through ``rlx_tpu.physics.engine.step`` and the
port's ``engine.step`` on CPU tensors (its eager plain path, which the CUDA
kernel is held against on the card).  Tolerance: rtol=atol=1e-5, the
tolerance of the JAX substep-kernel test, except where stated.
"""

import mujoco
import numpy as np
import pytest
import torch

from rlx_tpu.physics import engine as jax_engine
from rlx_tpu.physics import load_mjcf as jax_load_mjcf
from rlx_tpu_torch.environments.locomotion.ant.cuda.environment import ANT_MODEL
from rlx_tpu_torch.physics import engine, load_mjcf, load_model, save_model
from rlx_tpu_torch.ops.engine_substep_cuda import (
    BLOCK_THREADS, MAX_BLOCK_SHARED, body_levels, chain_entries, env_layout, lanes_per_env,
    ltdl_schedule, model_tables, step_cuda, substep_flops,
)
from tests.test_physics import ANT_XML, TEST_XML, random_state

RTOL = ATOL = 1e-5

# TEST_XML without its actuators: the nu == 0 path
NO_ACTUATOR_XML = TEST_XML.split("<actuator>")[0] + "</mujoco>\n"


def _models(which):
    if which == "ant":
        return (jax_load_mjcf(xml_path=ANT_XML, keyframe="home"),
                load_mjcf(xml_path=ANT_XML, keyframe="home"),
                mujoco.MjModel.from_xml_path(ANT_XML), 0.75)
    xml = {"chain": TEST_XML, "chain_no_actuators": NO_ACTUATOR_XML}[which]
    return (jax_load_mjcf(xml_string=xml), load_mjcf(xml_string=xml),
            mujoco.MjModel.from_xml_string(xml), 2.0)


def _batch(m, model, B, seed, free_height):
    rng = np.random.default_rng(seed)
    qpos = np.stack([random_state(m, rng, free_height)[0] for _ in range(B)]).astype(np.float32)
    qvel = np.stack([random_state(m, rng, free_height)[1] for _ in range(B)]).astype(np.float32)
    ctrl = rng.uniform(-0.5, 0.5, size=(B, len(model.act_dof))).astype(np.float32)
    return qpos, qvel, ctrl


def _assert_models_equal(a, b):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, (int, float, tuple)):
            assert x == y and type(x) is type(y), name
        else:
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("which", ["chain", "ant", "chain_no_actuators"])
def test_load_mjcf_matches_jax(which):
    jax_model, model, _, _ = _models(which)
    assert model._fields == jax_model._fields
    _assert_models_equal(jax_model, model)


def test_committed_ant_model_matches_mjcf(tmp_path):
    """The shipped ant_model.npz is the compiled ant.xml, and save/load
    round-trips every field."""
    compiled = load_mjcf(xml_path=ANT_XML, keyframe="home")
    _assert_models_equal(compiled, load_model(ANT_MODEL))
    path = str(tmp_path / "chain.npz")
    chain = load_mjcf(xml_string=TEST_XML)
    save_model(chain, path)
    _assert_models_equal(chain, load_model(path))


def _dr(model, B, seed):
    rng = np.random.default_rng(seed)
    u = lambda *shape: rng.uniform(0.8, 1.2, size=shape).astype(np.float32)
    nu = len(model.act_dof)
    return dict(
        mass_scale=u(model.nbody, B), damping_scale=u(B), frictionloss_scale=u(B),
        armature_scale=u(B), friction_scale=u(B), contact_stiffness_scale=u(B),
        kp_scale=u(nu, B), kv_scale=u(nu, B), forcerange_scale=u(nu, B),
        ctrl_offset=(0.1 * (u(nu, B) - 1.0)).astype(np.float32),
        gravity=(np.array([[0.0], [0.0], [-9.81]], np.float32) * u(B)).astype(np.float32),
    )


@pytest.mark.parametrize("which,anchors,with_dr", [
    ("ant", False, False),
    ("ant", True, False),
    ("ant", True, True),
    ("chain", False, False),
    ("chain", False, True),
    ("chain_no_actuators", False, False),
])
def test_step_matches_jax(which, anchors, with_dr):
    jax_model, model, m, height = _models(which)
    B = 16
    qpos, qvel, ctrl = _batch(m, model, B, 0, height)
    kw = dict(nr_substeps=4)
    tkw = dict(nr_substeps=4)
    if anchors:
        cs = np.asarray(jax_engine.contact_anchor_init(jax_model, qpos))
        np.testing.assert_allclose(
            engine.contact_anchor_init(model, torch.tensor(qpos)).numpy(), cs, rtol=RTOL, atol=ATOL
        )
        kw["contact_state"], tkw["contact_state"] = cs, torch.tensor(cs)
    if with_dr:
        dr = _dr(model, B, 1)
        kw["dr"] = jax_engine.DomainParams(**dr)
        tkw["dr"] = engine.DomainParams(**{k: torch.tensor(v) for k, v in dr.items()})
    ref = jax_engine.step(jax_model, qpos, qvel, ctrl, **kw)
    out = engine.step(model, torch.tensor(qpos), torch.tensor(qvel), torch.tensor(ctrl), **tkw)
    assert len(out) == len(ref)
    for o, r, name in zip(out, ref, ("qpos", "qvel", "anchors")):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL, err_msg=name)


def test_step_ctrl_sequence_matches_jax():
    jax_model, model, m, height = _models("chain")
    B, S = 8, 3
    qpos, qvel, _ = _batch(m, model, B, 2, height)
    seq = np.random.default_rng(3).uniform(-0.5, 0.5, size=(S, B, len(model.act_dof))).astype(np.float32)
    ref = jax_engine.step(jax_model, qpos, qvel, seq[0], nr_substeps=S, ctrl_sequence=seq)
    out = engine.step(model, torch.tensor(qpos), torch.tensor(qvel), torch.tensor(seq[0]),
                      nr_substeps=S, ctrl_sequence=torch.tensor(seq))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which", ["chain", "ant"])
def test_mass_matrix_bias_and_kinematics_match_jax(which):
    jax_model, model, m, height = _models(which)
    qpos, qvel, _ = _batch(m, model, 8, 4, height)
    M_ref, C_ref = jax_engine.mass_matrix_bias(jax_model, qpos, qvel)
    M, C = engine.mass_matrix_bias(model, torch.tensor(qpos), torch.tensor(qvel))
    np.testing.assert_allclose(M.numpy(), np.asarray(M_ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(C.numpy(), np.asarray(C_ref), rtol=RTOL, atol=ATOL)
    R_ref, p_ref = jax_engine.kinematics(jax_model, qpos)
    R, p = engine.kinematics(model, torch.tensor(qpos))
    np.testing.assert_allclose(R.numpy(), np.asarray(R_ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), rtol=RTOL, atol=ATOL)


def test_mass_matrix_matches_mujoco():
    """The port's CRBA mass matrix and bias against MuJoCo C (mj_fullM,
    qfrc_bias) on the Ant, at the JAX engine's golden tolerance (2e-3:
    float32 against MuJoCo's float64)."""
    _, model, m, _ = _models("ant")
    d = mujoco.MjData(m)
    qpos, qvel = random_state(m, np.random.default_rng(5), free_height=3.0)
    d.qpos[:], d.qvel[:] = qpos, qvel
    mujoco.mj_forward(m, d)
    full = np.zeros((m.nv, m.nv))
    mujoco.mj_fullM(m, d, full)
    M, C = engine.mass_matrix_bias(model, torch.tensor(qpos, dtype=torch.float32)[None],
                                   torch.tensor(qvel, dtype=torch.float32)[None])
    np.testing.assert_allclose(M[0].numpy(), full, rtol=2e-3, atol=2e-3)
    scale = np.maximum(np.abs(np.asarray(d.qfrc_bias)), 1.0)
    np.testing.assert_allclose(C[0].numpy() / scale, np.asarray(d.qfrc_bias) / scale, atol=2e-3)


def test_no_contacts_with_contact_state_returns_empty_anchors():
    """ncon == 0 with contact_state given returns [B, 0, 2], as the JAX
    engine's XLA path does."""
    jax_model, model, m, height = _models("chain")
    assert len(model.con_body) == 0
    qpos, qvel, ctrl = _batch(m, model, 4, 6, height)
    cs = np.zeros((4, 0, 2), np.float32)
    ref = jax_engine.step(jax_model, qpos, qvel, ctrl, contact_state=cs)
    out = engine.step(model, torch.tensor(qpos), torch.tensor(qvel), torch.tensor(ctrl),
                      contact_state=torch.tensor(cs))
    assert tuple(out[2].shape) == np.asarray(ref[2]).shape == (4, 0, 2)


def test_step_dispatch_and_unsupported_paths():
    _, model, m, height = _models("chain")
    qpos, qvel, ctrl = (torch.tensor(x) for x in _batch(m, model, 4, 7, height))
    for a, b in zip(engine.step(model, qpos, qvel, ctrl, nr_substeps=2),
                    engine.step_reference(model, qpos, qvel, ctrl, nr_substeps=2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        step_cuda(model, qpos, qvel, ctrl)
    with pytest.raises(NotImplementedError):
        engine.step(model, qpos, qvel, ctrl, terrain=object())


def test_kernel_tables_and_bound():
    """The kernel's flat table holds the model and the engine's derived
    constants; a model whose per-env state overflows a block's shared memory
    raises; the flop count is positive and grows with the model."""
    _, ant, _, _ = _models("ant")
    t = model_tables(ant, 0.015, 1.0, 200.0)
    assert [t.scalar(n) for n in ("nbody", "nq", "nv", "nu", "ncon")] == [13, 15, 14, 8, 8]
    lam, dof_body = engine.dof_structure(ant)
    assert list(t.section("dof_body")) == list(dof_body)
    assert list(t.section("parent")) == list(ant.parent)
    ent_start, ent_j = t.section("ent_start"), t.section("ent_j")
    assert [ent_j[ent_start[d] + 1] if lam[d] >= 0 else -1 for d in range(14)] == list(lam)
    dt = float(ant.timestep)
    assert t.scalar("timestep") == np.float32(dt)
    m_eff, m_app = float(ant.con_meff[0]), float(ant.con_m_app[0])
    np.testing.assert_allclose(t.section("con_k")[0], min(m_eff / 0.015 ** 2, 2.0 * m_app / dt ** 2), rtol=1e-6)
    limited = [i for i in range(ant.nbody) if ant.jnt_limited[i]]
    d = int(ant.dof_adr[limited[0]])
    i_arm = float(ant.dof_armature[d])
    np.testing.assert_allclose(
        t.section("dof_dlim")[d], min(2.0 * np.sqrt(200.0 * i_arm), 0.7 * i_arm / dt), rtol=1e-6
    )
    assert len(t.words) % 4 == 0 and t.used <= len(t.words) < t.used + 4
    assert t.shared_bytes == 4 * (len(t.words) + BLOCK_THREADS // 16 * t.env_floats) <= MAX_BLOCK_SHARED
    _, chain, _, _ = _models("chain")
    assert substep_flops(ant) > substep_flops(chain) > 0
    too_big = ant._replace(nbody=200)
    with pytest.raises(ValueError, match="nbody"):
        model_tables(too_big, 0.015, 1.0, 200.0)


def _ltdl_solve_as_kernel(t, M, rhs):
    """The kernel's tree-sparse LTDL factor of one env's M and its solve of
    M x = rhs, in float64, driven by the table's schedule sections as the
    kernel reads them."""
    sec = t.section
    ent_d, ent_j, ent_start = sec("ent_d"), sec("ent_j"), sec("ent_start")
    Mv = np.array([M[d, j] for d, j in zip(ent_d, ent_j)], dtype=np.float64)
    L = np.full(len(Mv), np.nan)
    inv_d = np.full(t.scalar("nv"), np.nan)
    x = np.array(rhs, dtype=np.float64)
    blk = lambda d, j: d * (d + 1) // 2 + d - j
    for g in range(t.scalar("ngroup")):
        for r in range(sec("grp_start")[g], sec("grp_start")[g + 1]):
            e, diag = sec("grp_ent")[r], sec("grp_diag")[r]
            if e == diag:
                inv_d[ent_d[e]] = 1.0 / Mv[diag]
            else:
                L[e] = Mv[e] / Mv[diag]
        for tt in range(sec("ftgt_start")[g], sec("ftgt_start")[g + 1]):
            for c in range(sec("ftgt_cstart")[tt], sec("ftgt_cstart")[tt + 1]):
                Mv[sec("ftgt_entry")[tt]] -= L[sec("fc_ki")[c]] * Mv[sec("fc_kj")[c]]
        for tt in range(sec("stgt_start")[g], sec("stgt_start")[g + 1]):
            for c in range(sec("stgt_cstart")[tt], sec("stgt_cstart")[tt + 1]):
                x[sec("stgt_dof")[tt]] -= L[sec("sc_e")[c]] * x[sec("sc_i")[c]]
    if t.scalar("free_block"):
        A = Mv[:21].copy()
        for k in range(5, -1, -1):
            inv_d[k] = 1.0 / A[blk(k, k)]
            for i in range(k - 1, -1, -1):
                a = A[blk(k, i)] * inv_d[k]
                for j in range(i, -1, -1):
                    A[blk(i, j)] -= a * A[blk(k, j)]
                A[blk(k, i)] = a
        for i in range(5, -1, -1):
            for j in range(i - 1, -1, -1):
                x[j] -= A[blk(i, j)] * x[i]
        x[:6] *= inv_d[:6]
        for i in range(6):
            for j in range(i - 1, -1, -1):
                x[i] -= A[blk(i, j)] * x[j]
    for D in range(t.scalar("ndepth")):
        for i in sec("depth_dof")[sec("depth_start")[D]: sec("depth_start")[D + 1]]:
            x[i] *= inv_d[i]
            for e in range(ent_start[i] + 1, ent_start[i + 1]):
                x[i] -= L[e] * x[ent_j[e]]
    return x


@pytest.mark.parametrize("which", ["ant", "chain"])
def test_kernel_schedule(which):
    """The host-side schedule of the substep kernel: every body's parent in
    an earlier level; M's chain entries are the nonzero pattern of
    ``mass_matrix_bias``'s M (with the free joint's zero translational
    couplings); the LTDL finishes each dof after its subtree, and the table's
    factor and solve schedule solves M x = b; the per-env shared memory is
    the model's count."""
    _, model, m, height = _models(which)
    nv, nbody, ncon = model.nv, model.nbody, len(model.con_body)
    levels = body_levels(model)
    level_of = {i: L for L, bodies in enumerate(levels) for i in bodies}
    assert sorted(level_of) == list(range(nbody))
    for i, L in level_of.items():
        par = int(model.parent[i])
        assert (L == 0) if par < 0 else level_of[par] == L - 1

    qpos, qvel, _ = _batch(m, model, 4, 8, height)
    M, _ = engine.mass_matrix_bias(model, torch.tensor(qpos), torch.tensor(qvel))
    M = M.double().numpy()
    entries, start = chain_entries(model)
    nonzero = {(d, j) for d in range(nv) for j in range(d + 1) if (M[:, d, j] != 0).any()}
    free_zero = {(int(model.dof_adr[i]) + a, int(model.dof_adr[i]) + b)
                 for i in range(nbody) if int(model.jnt_type[i]) == 0 for a in range(3) for b in range(a)}
    assert len(entries) == len(set(entries)) and set(entries) == nonzero | free_zero
    assert start == [0] + [sum(1 for d, _ in entries if d <= k) for k in range(nv)]
    assert all(entries[start[d]] == (d, d) for d in range(nv))

    lam, _ = engine.dof_structure(model)
    sched = ltdl_schedule(model)
    assert sorted(sched["order"]) == list(range(nv))
    assert all(group == sorted(group, reverse=True) for group in sched["groups"])
    seen = set()
    for k in sched["order"]:
        descendants = {d for d in range(nv) if d != k and k in _ancestors(lam, d)}
        assert descendants <= seen, (k, descendants - seen)
        seen.add(k)

    t = model_tables(model, 0.015, 1.0, 200.0)
    rhs = np.random.default_rng(9).normal(size=nv)
    for b in range(M.shape[0]):
        np.testing.assert_allclose(_ltdl_solve_as_kernel(t, M[b], rhs), np.linalg.solve(M[b], rhs),
                                   rtol=1e-9, atol=1e-9)

    nent = len(entries)
    offsets, env_floats = env_layout(nbody, model.nq, nv, ncon, nent)
    assert env_floats == t.env_floats == (model.nq + nv + 2 * ncon + 3 + (9 + 3 + 4 * 6 + 13) * nbody
                                          + 6 * ncon + 6 * nv + 2 * nent + 2 * nv)
    assert list(offsets.values()) == sorted(offsets.values()) and offsets["inv_d"] + nv == env_floats
    assert [t.scalar("o_" + n) for n in offsets] == list(offsets.values())
    assert lanes_per_env(4096) == 16 and lanes_per_env(1024) == 32


def _ancestors(lam, d):
    out = []
    while lam[d] >= 0:
        d = int(lam[d])
        out.append(d)
    return out
