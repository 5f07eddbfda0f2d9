"""Tensor parallelism in the port (``rlx_tpu_torch/parallel/partition.py``),
mirroring the JAX package's ``tests/test_tp_partition.py``:

- the rules: Dense weights alternate column / row, the same specs as
  ``rlx_tpu.parallel.partition.tp_specs_for_tree`` on the same widths,
  with its fallback where a width does not divide;
- on a real mesh, one spawn of 4 gloo ranks (dp = 2 x tp = 2,
  ``torch_mesh_worker.py``): one PPO iteration on the Ant with its nets
  split over tp (a column-split trunk layer with its LayerNorm, a row
  layer, a column head and a row-split value head) equals the unsplit
  dp = 1 run here, in the forward pass, the parameters and Adam's moments
  (the checkpoint's whole form; f32, 1e-5).
"""

import numpy as np
import pytest
import torch
from torch import nn

import torch_mesh_worker as worker
from rlx_tpu_torch.config import create_model
from rlx_tpu_torch.parallel.partition import (
    COLUMN, REPLICATED, ROW, alternating_mlp_rules, match_partition_rules, tp_specs_for_tree,
)
from torch_mesh_spawn import shared_results, spawn
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)


class _MLP(nn.Module):
    """The JAX test's ``_MLP``: Dense layers of ``features`` over ``in_features``."""

    def __init__(self, in_features, features):
        super().__init__()
        sizes = (in_features,) + tuple(features)
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))


def _weight_specs(module, tp_size=2):
    specs = tp_specs_for_tree(dict(module.named_parameters()), tp_size)
    return [specs[f"layers.{i}.weight"] for i in range(len(module.layers))]


def _jax_kernel_specs(features, in_features):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from rlx_tpu.parallel.partition import tp_specs_for_tree as jax_specs
    from test_tp_partition import _MLP as JaxMLP
    from test_tp_partition import _kernel_specs

    params = JaxMLP(tuple(features)).init(jax.random.PRNGKey(0), jnp.zeros((4, in_features)))
    names = {P(None, "tp"): COLUMN, P("tp", None): ROW, P(): REPLICATED}
    return [names[spec] for _, spec in _kernel_specs(params, jax_specs(params, tp_size=2))]


def test_alternating_column_row_orientation():
    module = _MLP(16, (128, 128, 128, 128))
    assert _weight_specs(module) == [COLUMN, ROW, COLUMN, ROW]
    assert _weight_specs(module) == _jax_kernel_specs((128, 128, 128, 128), 16)
    # biases and other leaves replicate
    specs = tp_specs_for_tree(dict(module.named_parameters()), 2)
    assert all(spec == REPLICATED for name, spec in specs.items() if name.endswith(".bias"))
    assert [s for n, s in alternating_mlp_rules(dict(module.named_parameters())).items()
            if n.endswith("weight")] == [COLUMN, ROW, COLUMN, ROW]


def test_indivisible_dims_fall_back():
    """Dense_1 (128 -> 127) cannot split its outputs and prefers row anyway;
    Dense_2 (127 -> 128) prefers column; a wholly odd layer replicates."""
    module = _MLP(16, (128, 127, 128))
    assert _weight_specs(module) == [COLUMN, ROW, COLUMN] == _jax_kernel_specs((128, 127, 128), 16)
    odd = _MLP(15, (127,))
    assert _weight_specs(odd) == [REPLICATED] == _jax_kernel_specs((127,), 15)
    # a column preference falls back to row where the outputs do not divide
    assert _weight_specs(_MLP(16, (127, 128)))[0] == ROW


def test_match_partition_rules():
    module = _MLP(16, (8, 4))
    params = {**dict(module.named_parameters()), "scalar": nn.Parameter(torch.zeros(()))}
    specs = match_partition_rules([(r"layers\.0\.weight", COLUMN), (r"weight$", ROW)], params)
    assert specs["layers.0.weight"] == COLUMN and specs["layers.1.weight"] == ROW
    assert specs["layers.0.bias"] == REPLICATED and specs["scalar"] == REPLICATED


@pytest.fixture(scope="session")
def tp_results(tmp_path_factory):
    return shared_results(tmp_path_factory, "torch_partition", lambda d: spawn(["tp"], 4, d))


def test_tp2_equals_tp1(tp_results):
    """dp = 2 x tp = 2 against the unsplit dp = 1 run: the forward of fixed
    observations, and the whole parameters and Adam moments after one
    iteration (the checkpoint, ``save_optimizer_state``)."""
    got = torch.load(tp_results / "tp.dp.pt")
    ref_config = worker._tp_config()
    ref_config.runner.mesh_dp = ref_config.runner.mesh_tp = 1
    ref = create_model(ref_config)
    ref.train()
    obs = torch.linspace(-1.0, 1.0, 6 * 34).reshape(6, 34)
    with torch.no_grad():
        torch.testing.assert_close(got["forward"]["policy"], ref.policy.module(obs)[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got["forward"]["critic"], ref.critic(obs), rtol=1e-5, atol=1e-5)
    tree, ref_tree = got["tree"]["full"], ref.checkpoint_tree()["full"]
    for name in ("policy", "critic"):
        for key, value in ref_tree[name]["params"].items():
            torch.testing.assert_close(tree[name]["params"][key], value, rtol=1e-5, atol=1e-5,
                                       msg=lambda m: f"{name} {key}: {m}")
        moments = ref_tree[name]["opt_state"]["state"]
        assert moments, name
        for index, state in moments.items():
            for key in ("exp_avg", "exp_avg_sq"):
                torch.testing.assert_close(tree[name]["opt_state"]["state"][index][key], state[key], rtol=1e-5,
                                           atol=1e-8, msg=lambda m: f"{name} moment {index} {key}: {m}")
    assert np.isfinite(float(got["forward"]["critic"].sum()))
