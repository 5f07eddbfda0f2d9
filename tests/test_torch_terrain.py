"""Heightfield terrain in the port's engine against the JAX engine, and the
robots' committed models.

- ``terrain_height_T`` on random heights at random points and at points
  half a cell between two (rounded half to even on both sides);
- ``step`` over a heightfield on the quadruped at B=4 (the eager path on
  every device) with stick anchors, a per-env ``DomainParams`` whose damping
  scale is per dof (``[nv, B]``, the robots' joint locks) and a control
  sequence that changes between substeps, against the JAX engine's
  ``step`` (rtol=atol=1e-5).  Both sides run in float64: through the stiff
  penalty contacts of four substeps on rough ground, f32 rounding alone
  moves a joint velocity by 3e-5;
- each robot's ``.npz`` equals a fresh ``load_mjcf`` of its XML (where
  ``mujoco`` is there to compile it).
"""

import numpy as np
import pytest
import torch

from rlx_tpu_torch.environments.locomotion.robot.robots.configs import ROBOT_CONFIGS
from rlx_tpu_torch.physics import engine, load_model
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

TOL = 1e-5
B = 4


def _heights(rng, n, top=0.3):
    return rng.uniform(0.0, top, size=(n * n, B)).astype(np.float32)


def test_terrain_height_matches_jax():
    from rlx_tpu.physics import engine as jax_engine

    rng = np.random.default_rng(0)
    n, half = 16, 2.0
    heights = _heights(rng, n)
    cell = 2.0 * half / n
    x = rng.uniform(-2.5, 2.5, size=(6, B)).astype(np.float32)
    y = rng.uniform(-2.5, 2.5, size=(6, B)).astype(np.float32)
    # half-way between two cells: jnp.round and torch.round both go to even
    x[0] = (np.arange(B) + 0.5) * cell
    y[1] = -(np.arange(B) + 0.5) * cell
    ref = jax_engine.terrain_height_T(jax_engine.Terrain(height=heights, n=n, half_extent_m=half), x, y)
    out = engine.terrain_height_T(engine.Terrain(height=torch.tensor(heights), n=n, half_extent_m=half),
                                  torch.tensor(x), torch.tensor(y))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _quadruped_batch(model, rng):
    qpos = np.tile(np.asarray(model.qpos0, np.float32), (B, 1))
    qpos[:, 0:2] += rng.uniform(-1.0, 1.0, size=(B, 2))
    qpos[:, 2] += rng.uniform(-0.05, 0.05, size=B)
    qpos[:, 7:] += rng.uniform(-0.2, 0.2, size=(B, model.nq - 7))
    qvel = rng.uniform(-0.5, 0.5, size=(B, model.nv)).astype(np.float32)
    nu = len(model.act_dof)
    targets = (qpos[None, :, 7:] + rng.uniform(-0.3, 0.3, size=(4, B, nu))).astype(np.float32)
    return qpos.astype(np.float32), qvel, targets


def _domain_params(model, rng):
    u = lambda *shape: rng.uniform(0.8, 1.2, size=shape).astype(np.float32)
    nu = len(model.act_dof)
    return dict(
        mass_scale=u(model.nbody, B), damping_scale=u(model.nv, B), frictionloss_scale=u(B),
        armature_scale=u(B), friction_scale=u(B), contact_stiffness_scale=u(B),
        kp_scale=u(nu, B), kv_scale=u(nu, B), forcerange_scale=u(nu, B),
        gravity=(np.array([[0.3], [-0.2], [-9.81]], np.float32) * u(B)).astype(np.float32),
    )


def test_heightfield_step_matches_jax():
    import jax

    with jax.enable_x64(True):
        _heightfield_step_matches_jax()


def _heightfield_step_matches_jax():
    from rlx_tpu.physics import engine as jax_engine
    from rlx_tpu.physics import load_mjcf as jax_load_mjcf

    config = ROBOT_CONFIGS["quadruped"]
    jax_model = jax_load_mjcf(xml_path=config["xml_path"], keyframe="home")
    model = load_model(config["model_path"])
    rng = np.random.default_rng(1)
    n, half = 64, 4.0
    heights = _heights(rng, n, top=0.04)   # the roughness of the curriculum's first levels
    qpos, qvel, targets = _quadruped_batch(model, rng)
    qpos[:, 2] += 0.02  # every foot near the ground, some in it
    dr = {k: v.astype(np.float64) for k, v in _domain_params(model, rng).items()}
    qpos, qvel, targets, heights = (a.astype(np.float64) for a in (qpos, qvel, targets, heights))
    anchors = np.asarray(jax_engine.contact_anchor_init(jax_model, qpos))
    ref = jax_engine.step(
        jax_model, qpos, qvel, targets[0], nr_substeps=4, dr=jax_engine.DomainParams(**dr),
        terrain=jax_engine.Terrain(height=heights, n=n, half_extent_m=half), ctrl_sequence=targets,
        contact_state=anchors,
    )
    args = (model, torch.tensor(qpos), torch.tensor(qvel), torch.tensor(targets[0]))
    kwargs = dict(nr_substeps=4, dr=engine.DomainParams(**{k: torch.tensor(v) for k, v in dr.items()}),
                  terrain=engine.Terrain(height=torch.tensor(heights), n=n, half_extent_m=half),
                  ctrl_sequence=torch.tensor(targets), contact_state=torch.tensor(anchors))
    out = engine.step(*args, **kwargs)
    for o, r, name in zip(out, ref, ("qpos", "qvel", "anchors")):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=TOL, atol=TOL, err_msg=name)
    for o, r in zip(engine.step_reference(*args, **kwargs), out):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
    # the ground was felt: the same step on the plane differs
    plane = engine.step(*args, **{**kwargs, "terrain": None})
    assert not torch.allclose(plane[0], out[0])


@pytest.mark.parametrize("robot", sorted(ROBOT_CONFIGS))
def test_committed_robot_model_matches_mjcf(robot):
    pytest.importorskip("mujoco")
    from rlx_tpu_torch.physics import load_mjcf

    config = ROBOT_CONFIGS[robot]
    compiled = load_mjcf(config["xml_path"], keyframe="home")
    saved = load_model(config["model_path"])
    assert compiled._fields == saved._fields
    for name in compiled._fields:
        x, y = getattr(compiled, name), getattr(saved, name)
        if isinstance(x, (int, float, tuple)):
            assert x == y and type(x) is type(y), name
        else:
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)
