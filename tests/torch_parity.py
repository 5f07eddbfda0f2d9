"""Helpers shared by the port's parity tests of the SAC family: the JAX and
the port's model built from the same overrides, numpy copies of JAX trees,
state-dict comparison and seeded batches; and ``NoHostRead``, the dispatch
mode the capture tests run a learning iteration (or the engine) under."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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


def assert_tree_close(ours, ref, tol, what):
    """Two nested dicts of tensors with the same keys, every tensor within
    ``tol`` (rtol and atol)."""
    assert set(ours) == set(ref), (what, sorted(set(ours) ^ set(ref)))
    for key in ref:
        if isinstance(ref[key], dict):
            assert_tree_close(ours[key], ref[key], tol, f"{what} {key}")
        else:
            torch.testing.assert_close(ours[key], ref[key].to(ours[key].dtype), rtol=tol, atol=tol,
                                       msg=lambda m: f"{what} {key}: {m}")


def adam_moments(optimizer, module):
    """``{parameter name: Adam's first moment}`` of ``module``'s parameters."""
    return {name: optimizer.state[p]["exp_avg"] for name, p in module.named_parameters()}


def jax_adam_mu(opt_state):
    """The first moment (``mu``) of the Adam state inside an optax state."""
    import jax

    for node in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(node, "mu"):
            return np_tree(node.mu)
    raise ValueError("no Adam state")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Runs a test with one torch CPU thread: the suite's workers share the
    machine's cores, and torch's thread pools spin against each other there
    (a FastMPO CPU train took 121 s among six workers, 1.5 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class NoHostRead(TorchDispatchMode):
    """Raises on an op that reads a tensor's value on the host
    (``aten._local_scalar_dense``: ``.item()``, ``float()``, ``bool()`` of a
    tensor) or makes a tensor from host data (``aten.lift_fresh``, which a
    CUDA graph would freeze at its capture value, and a card capture
    refuses as an H2D copy); inside it ``torch.Generator(...)`` raises
    too."""

    def __init__(self):
        super().__init__()
        self.forbidden = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.lift_fresh.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.forbidden:
            raise AssertionError(f"{func} inside the learning iteration")
        return func(*args, **(kwargs or {}))

    def __enter__(self):
        real = torch.Generator

        class Refuse(type):
            def __instancecheck__(cls, obj):
                return isinstance(obj, real)

            def __call__(cls, *args, **kwargs):
                raise AssertionError("a new torch.Generator inside the learning iteration")

        self._real = real
        torch.Generator = Refuse("Generator", (), {})
        return super().__enter__()

    def __exit__(self, *exc):
        torch.Generator = self._real
        return super().__exit__(*exc)
