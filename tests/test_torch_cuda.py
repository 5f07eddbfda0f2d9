"""Kernels of rlx_tpu_torch against their plain versions on the card.

These tests need an NVIDIA GPU and skip without one.  They import neither
jax nor rlx_tpu, so they also run on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from rlx_tpu_torch.environments.locomotion.ant.cuda.environment import ANT_MODEL
from rlx_tpu_torch.ops.distributional import categorical_projection_dense, categorical_projection_reference
from rlx_tpu_torch.ops import engine_substep_cuda
from rlx_tpu_torch.ops.engine_substep_cuda import step_cuda
from rlx_tpu_torch.ops.gae import gae_advantages_reference
from rlx_tpu_torch.ops.gae_cuda import gae_advantages_cuda
from rlx_tpu_torch.ops.projection_cuda import categorical_projection_cuda
from rlx_tpu_torch.physics import engine, load_model


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_gae_kernel_matches_reference(cuda):
    """f32, same operation order: rtol=atol=1e-5; ragged B."""
    rng = np.random.default_rng(4)
    r, v, nv = (torch.tensor(rng.normal(size=(64, 4097)), dtype=torch.float32, device=cuda)
                for _ in range(3))
    d = torch.tensor(rng.random((64, 4097)) < 0.05, device=cuda)
    launches = gae_advantages_cuda.launches
    out = gae_advantages_cuda(r, v, nv, d, 0.99, 0.95)
    assert gae_advantages_cuda.launches == launches + 1
    for o, x in zip(out, gae_advantages_reference(r, v, nv, d, 0.99, 0.95)):
        torch.testing.assert_close(o, x, rtol=1e-5, atol=1e-5)


def _ant_variant(which):
    """The Ant, or the Ant without contacts / actuators (the ncon == 0 and
    nu == 0 branches; the card has no mujoco to compile another XML)."""
    model = load_model(ANT_MODEL)
    if which == "no_contacts":
        fields = ("con_body", "con_pos", "con_radius", "con_friction", "con_meff",
                  "con_m_app", "con_m_app_t")
    elif which == "no_actuators":
        fields = ("act_dof", "act_joint_body", "act_kp", "act_kv", "act_gear",
                  "act_is_position", "act_forcerange")
    else:
        fields = ()
    return model._replace(**{f: getattr(model, f)[:0] for f in fields})


def _ant_state(model, B, cuda, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    qpos0 = torch.as_tensor(model.qpos0, device=cuda)
    qpos = qpos0.repeat(B, 1) + 0.1 * torch.randn(B, model.nq, device=cuda, generator=g)
    qpos[:, 2] = 0.55 + 0.2 * torch.rand(B, device=cuda, generator=g)
    qpos[:, 3:7] /= qpos[:, 3:7].norm(dim=1, keepdim=True)
    qvel = 0.5 * torch.randn(B, model.nv, device=cuda, generator=g)
    nu = len(model.act_dof)
    ctrl = qpos0[7:7 + nu] + 0.3 * (2.0 * torch.rand(B, nu, device=cuda, generator=g) - 1.0)
    return qpos, qvel, ctrl, g


def _domain_params(model, B, cuda, g):
    u = lambda *shape: 0.8 + 0.4 * torch.rand(*shape, device=cuda, generator=g)
    nu = len(model.act_dof)
    return engine.DomainParams(
        mass_scale=u(model.nbody, B), damping_scale=u(B), frictionloss_scale=u(B),
        armature_scale=u(B), friction_scale=u(B), contact_stiffness_scale=u(B),
        kp_scale=u(nu, B), kv_scale=u(nu, B), forcerange_scale=u(nu, B),
        ctrl_offset=0.1 * (u(nu, B) - 1.0),
        gravity=torch.tensor([0.0, 0.0, -9.81], device=cuda)[:, None] * u(B),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("which,B,case", [
    ("ant", 256, "entry-pose anchors"),
    ("ant", 256, "given anchors"),
    ("ant", 4096, "all DomainParams"),
    ("ant", 1024, "given anchors"),
    ("ant", 1000, "all DomainParams"),
    ("ant", 1000, "ctrl_sequence"),
    ("no_contacts", 1000, "given anchors"),
    ("no_contacts", 256, "all DomainParams"),
    ("no_actuators", 1000, "entry-pose anchors"),
    ("no_actuators", 256, "all DomainParams"),
])
@pytest.mark.parametrize("lanes", [32, 16])
def test_substep_kernel_matches_reference(cuda, monkeypatch, which, B, case, lanes):
    """4 substeps (3 for ctrl_sequence), ragged B = 1000 included, at 32
    and 16 lanes per env; 1e-4 because the kernel sums in another order and
    contracts multiply-adds, which stiff contacts amplify."""
    monkeypatch.setattr(engine_substep_cuda, "lanes_per_env", lambda B: lanes)
    model = _ant_variant(which)
    qpos, qvel, ctrl, g = _ant_state(model, B, cuda)
    kw = {}
    if case != "entry-pose anchors":
        kw["contact_state"] = engine.contact_anchor_init(model, qpos)
    if case == "all DomainParams":
        kw["dr"] = _domain_params(model, B, cuda, g)
    if case == "ctrl_sequence":
        kw["ctrl_sequence"] = ctrl[None] + 0.1 * torch.randn(3, *ctrl.shape, device=cuda, generator=g)
    launches = step_cuda.launches
    out = step_cuda(model, qpos, qvel, ctrl, nr_substeps=4, **kw)
    assert step_cuda.launches == launches + 1
    ref = engine.step_reference(model, qpos, qvel, ctrl, nr_substeps=4, **kw)
    assert len(out) == len(ref) == (3 if "contact_state" in kw else 2)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_engine_step_dispatches_cuda_tensors_to_the_kernel(cuda):
    model = load_model(ANT_MODEL)
    qpos = torch.as_tensor(model.qpos0, device=cuda)[None].repeat(32, 1)
    qvel = torch.zeros(32, model.nv, device=cuda)
    launches = step_cuda.launches
    engine.step(model, qpos, qvel, qpos[:, 7:], nr_substeps=2)
    assert step_cuda.launches == launches + 1


@pytest.mark.cuda
def test_projection_kernel_matches_reference(cuda):
    """Ragged N, A_in != nr_atoms, positions beyond the support and on
    atoms; f32 with the same division, sums in another order: 1e-6."""
    rng = np.random.default_rng(5)
    z = rng.uniform(-14.0, 14.0, size=(1027, 51)).astype(np.float32)
    z[0, :3] = [-10.0, 0.0, 10.0]
    logits = rng.normal(size=z.shape)
    p = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    z, p = torch.tensor(z, device=cuda), torch.tensor(p, device=cuda)
    launches = categorical_projection_cuda.launches
    out = categorical_projection_dense(z, p, -10.0, 10.0, 101)
    assert categorical_projection_cuda.launches == launches + 1
    torch.testing.assert_close(out, categorical_projection_reference(z, p, -10.0, 10.0, 101),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(RuntimeError):
        categorical_projection_cuda(z, p.requires_grad_(), -10.0, 10.0, 101)
