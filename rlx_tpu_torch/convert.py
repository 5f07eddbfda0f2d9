"""Carry PPO weights from the JAX package's flax parameters to the port.

The input is a flax parameter tree as nested dicts of numpy arrays
(``policy_state.params`` / ``critic_state.params``, with or without the
outer ``"params"`` key).  Dense kernels are stored ``[in, out]`` by flax and
``[out, in]`` by ``nn.Linear``, so they are transposed; LayerNorm
``scale``/``bias`` become ``weight``/``bias``.
"""

import numpy as np
import torch


def _unwrap(params):
    return params["params"] if "params" in params else params


def _dense(prefix, p):
    return {
        f"{prefix}.weight": torch.as_tensor(np.asarray(p["kernel"], np.float32).T.copy()),
        f"{prefix}.bias": torch.as_tensor(np.asarray(p["bias"], np.float32).copy()),
    }


def _mlp(p):
    out = {}
    n_dense = sum(1 for k in p if k.startswith("Dense_"))
    for i in range(n_dense):
        out.update(_dense(f"trunk.layers.{i}", p[f"Dense_{i}"]))
    if "LayerNorm_0" in p:
        ln = p["LayerNorm_0"]
        out["trunk.norm.weight"] = torch.as_tensor(np.asarray(ln["scale"], np.float32).copy())
        out["trunk.norm.bias"] = torch.as_tensor(np.asarray(ln["bias"], np.float32).copy())
    return out


def policy_state_dict(flax_params):
    """``GaussianPolicy`` state_dict from flax ``GaussianPolicy`` params."""
    p = _unwrap(flax_params)
    out = _mlp(p["MLP_0"])
    out.update(_dense("mean", p["Dense_0"]))
    out["policy_logstd"] = torch.as_tensor(np.asarray(p["policy_logstd"], np.float32).copy())
    return out


def critic_state_dict(flax_params):
    """``VCritic`` state_dict from flax ``VCritic`` params."""
    p = _unwrap(flax_params)
    out = _mlp(p["MLP_0"])
    out.update(_dense("value", p["Dense_0"]))
    return out
