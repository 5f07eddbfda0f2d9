"""MLP policy and critic networks.

Init follows the JAX package: orthogonal kernels with sqrt(2) gain on the
trunk, 0.01 on the policy head, 1.0 on the value head, zero biases, and a
state-independent ``policy_logstd`` of shape ``(1, action_dim)``.

``compute_dtype`` is the trunk's compute type (parameters stay float32):
with bfloat16 the trunk's products run in bfloat16, while the heads, the
distribution math and Adam stay float32.  LayerNorm uses eps=1e-6 (flax's
default; torch's is 1e-5).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": F.relu,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "swish": F.silu,
}

LAYER_NORM_EPS = 1e-6


def _orthogonal_linear(in_features, out_features, gain):
    layer = nn.Linear(in_features, out_features)
    nn.init.orthogonal_(layer.weight, gain=gain)
    nn.init.zeros_(layer.bias)
    return layer


class MLP(nn.Module):
    """Dense -> (LayerNorm after the first Dense) -> activation, per layer."""

    def __init__(self, in_features, hidden_sizes, activation="tanh", layer_norm=False,
                 kernel_gain=math.sqrt(2), compute_dtype=None):
        super().__init__()
        sizes = [in_features] + list(hidden_sizes)
        self.layers = nn.ModuleList(
            _orthogonal_linear(a, b, kernel_gain) for a, b in zip(sizes[:-1], sizes[1:])
        )
        self.norm = nn.LayerNorm(hidden_sizes[0], eps=LAYER_NORM_EPS) if layer_norm else None
        self.activation = ACTIVATIONS[activation]
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dtype = self.compute_dtype or torch.float32
        x = x.to(dtype)
        for i, layer in enumerate(self.layers):
            x = F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype))
            if i == 0 and self.norm is not None:
                # statistics in float32, output in the compute type
                x = F.layer_norm(x.float(), self.norm.normalized_shape, self.norm.weight,
                                 self.norm.bias, self.norm.eps).to(dtype)
            x = self.activation(x)
        return x.float()


class GaussianPolicy(nn.Module):
    """obs -> (mean, logstd) with a state-independent logstd parameter."""

    def __init__(self, obs_dim, action_dim, hidden_sizes, activation="tanh", layer_norm=False,
                 std_dev=1.0, compute_dtype=None):
        super().__init__()
        self.trunk = MLP(obs_dim, hidden_sizes, activation, layer_norm, compute_dtype=compute_dtype)
        self.mean = _orthogonal_linear(hidden_sizes[-1], action_dim, 0.01)
        self.policy_logstd = nn.Parameter(torch.full((1, action_dim), math.log(std_dev)))

    def forward(self, x):
        return self.mean(self.trunk(x)), self.policy_logstd


class VCritic(nn.Module):
    """obs -> state value [..., 1]."""

    def __init__(self, obs_dim, hidden_sizes, activation="tanh", layer_norm=False,
                 compute_dtype=None):
        super().__init__()
        self.trunk = MLP(obs_dim, hidden_sizes, activation, layer_norm, compute_dtype=compute_dtype)
        self.value = _orthogonal_linear(hidden_sizes[-1], 1, 1.0)

    def forward(self, x):
        return self.value(self.trunk(x))
