"""Helpers shared by the port's parity tests of the SAC family: the JAX and
the port's model built from the same overrides, numpy copies of JAX trees,
state-dict comparison and seeded batches."""

import numpy as np
import torch

from rlx_tpu_torch.config import create_model, make_config


def np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def close(ours, ref, tol, what):
    if isinstance(ours, torch.Tensor):
        ours = ours.detach().numpy()
    np.testing.assert_allclose(np.asarray(ours, np.float64), np.asarray(ref, np.float64), rtol=tol, atol=tol,
                               err_msg=what)


def models(algorithm, overrides, environment="classic.pendulum"):
    """(JAX model, port model on the CPU) of ``algorithm`` (no suffix)."""
    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config

    jmodel = jax_create_model(jax_make_config(f"{algorithm}.tpu", f"{environment}.tpu", **overrides,
                                              **{"runner.mesh_dp": 1}))
    model = create_model(make_config(f"{algorithm}.cuda", f"{environment}.cuda", **overrides,
                                     **{"runner.device": "cpu"}))
    return jmodel, model


def assert_state_dict(module, ref, tol, what):
    got = module.state_dict()
    assert set(got) == set(ref), (what, sorted(set(got) ^ set(ref)))
    for key in ref:
        torch.testing.assert_close(got[key], ref[key].to(got[key].dtype), rtol=tol, atol=tol,
                                   msg=lambda m: f"{what} {key}: {m}")


def batch(rng, size, obs_dim, action_dim, scale=1.0):
    out = {
        "observation": scale * rng.normal(size=(size, obs_dim)),
        "action": rng.uniform(-1, 1, size=(size, action_dim)),
        "next_observation": scale * rng.normal(size=(size, obs_dim)),
        "reward": rng.normal(size=size),
        "terminated": (rng.random(size) < 0.25).astype(np.float64),
        "truncated": np.zeros(size),
    }
    return {k: v.astype(np.float32) for k, v in out.items()}


def to_torch(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def normals(key, shape):
    import jax

    return torch.tensor(np.asarray(jax.random.normal(key, shape)))


def same_tree(a, b):
    """The number of tensors, asserting every one equal bit for bit and
    every other leaf equal."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        return sum(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        return sum(same_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
        return 1
    assert a == b
    return 0
