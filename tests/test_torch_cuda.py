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


@pytest.mark.cuda
@pytest.mark.parametrize("anchors", [False, True])
def test_substep_kernel_matches_reference(cuda, anchors):
    """Ant, 4 substeps; 1e-4 because the kernel sums in another order and
    contracts multiply-adds, which stiff contacts amplify."""
    model = load_model(ANT_MODEL)
    B = 256
    g = torch.Generator(device=cuda).manual_seed(0)
    qpos = torch.as_tensor(model.qpos0, device=cuda).repeat(B, 1)
    qpos[:, 2] += 0.1 * torch.rand(B, device=cuda, generator=g)
    qvel = 0.5 * torch.randn(B, model.nv, device=cuda, generator=g)
    ctrl = qpos[:, 7:] + 0.3 * torch.randn(B, 8, device=cuda, generator=g)
    kw = {"contact_state": engine.contact_anchor_init(model, qpos)} if anchors else {}
    out = step_cuda(model, qpos, qvel, ctrl, nr_substeps=4, **kw)
    ref = engine.step_reference(model, qpos, qvel, ctrl, nr_substeps=4, **kw)
    assert len(out) == len(ref) == (3 if anchors else 2)
    for o, r in zip(out, ref):
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
