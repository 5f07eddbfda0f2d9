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
from rlx_tpu_torch.ops.engine_substep_cuda import model_tables, step_cuda, substep_flops
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
    """Host-side kernel tables hold the model and the engine's derived
    constants; the flop count is positive and grows with the model."""
    _, ant, _, _ = _models("ant")
    ti, tf = model_tables(ant, 0.015, 1.0, 200.0)
    assert (ti.nbody, ti.nq, ti.nv, ti.nu, ti.ncon) == (13, 15, 14, 8, 8)
    lam, dof_body = engine.dof_structure(ant)
    assert list(ti.lam)[:14] == list(lam) and list(ti.dof_body)[:14] == list(dof_body)
    dt = float(ant.timestep)
    m_eff, m_app = float(ant.con_meff[0]), float(ant.con_m_app[0])
    np.testing.assert_allclose(tf.con_k[0], min(m_eff / 0.015 ** 2, 2.0 * m_app / dt ** 2), rtol=1e-6)
    limited = [i for i in range(ant.nbody) if ant.jnt_limited[i]]
    i_arm = float(ant.dof_armature[int(ant.dof_adr[limited[0]])])
    np.testing.assert_allclose(
        tf.jnt_dlim[limited[0]], min(2.0 * np.sqrt(200.0 * i_arm), 0.7 * i_arm / dt), rtol=1e-6
    )
    _, chain, _, _ = _models("chain")
    assert substep_flops(ant) > substep_flops(chain) > 0
    too_big = ant._replace(nbody=100)
    with pytest.raises(ValueError, match="nbody"):
        model_tables(too_big, 0.015, 1.0, 200.0)
