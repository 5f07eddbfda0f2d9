"""Building blocks of the scaled-network SAC variants (the JAX package's
``models/layers.py``):

- pre-LN residual MLP blocks and the SimBa encoder (SimBa, XQC);
- BroNet residual trunks (BRO);
- hypersphere layers: ``l2_normalize``, ``Scaler``, ``HyperDense``,
  ``HyperEmbedder``, ``HyperLERPBlock``, ``HyperHead`` and the SimbaV2
  encoder (SimbaV2);
- ``BatchRenorm`` (CrossQ).

Every layer takes ``nr``: ``None`` for one network, or the size of an
ensemble whose members' parameters are stacked on a leading axis (the JAX
package's ``nn.vmap``-ed critics).  An ensemble maps a shared ``[B, d]``
input or a per-member ``[nr, B, d]`` input to ``[nr, B, d']``.  Weights are
stored as ``nn.Linear`` stores them, ``[..., out, in]``.

Layers with running statistics (``BatchRenorm`` here, FlashSAC's
``BatchNorm``) keep them in buffers, so they are part of ``state_dict()``
and of every checkpoint, and a ``TrainState``'s Polyak update (parameters
only) leaves a target's statistics to its own forward passes.  A
train-mode forward leaves the batch statistics pending, as flax returns
its mutated ``batch_stats`` beside the output; ``commit_batch_stats``
applies them, ``discard_batch_stats`` drops them.  Such a layer names its
statistics' buffers in ``running_buffers`` (``running_buffers(module)``
finds them all): with parallel seeds they are seed-stacked beside the
parameters, where constant buffers (observation indices, bins) stay shared.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from rlx_tpu_torch.models.mlp import LAYER_NORM_EPS, TRUNCATED_NORMAL_STDDEV, lecun_normal_


def he_normal_(weight):
    """flax's ``he_normal``: a normal truncated at two standard deviations,
    variance 2 / fan_in (fan_in the last axis)."""
    std = math.sqrt(2.0 / weight.shape[-1]) / TRUNCATED_NORMAL_STDDEV
    return nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std)


def orthogonal_(weight, gain=1.0):
    """Orthogonal init of each ``[out, in]`` matrix of ``weight``."""
    for matrix in weight.reshape(-1, *weight.shape[-2:]):
        nn.init.orthogonal_(matrix, gain=gain)
    return weight


INITS = {"lecun": lecun_normal_, "he": he_normal_, "orthogonal": orthogonal_}


def ensemble_input(x, nr):
    """A shared ``[B, d]`` input repeated for each of ``nr`` members."""
    if nr is not None and x.ndim == 2:
        return x.unsqueeze(0).expand(nr, *x.shape)
    return x


def row(p):
    """A per-feature parameter ``[d]`` or ``[nr, d]``, broadcast against
    ``[B, d]`` or ``[nr, B, d]``."""
    return p if p.ndim == 1 else p[:, None, :]


def linear(x, weight, bias=None):
    """``x @ weight^T (+ bias)`` for one weight ``[out, in]`` or stacked
    weights ``[nr, out, in]``."""
    if weight.ndim == 2:
        return F.linear(x, weight, bias)
    if x.ndim == 2:
        out = torch.einsum("bi,noi->nbo", x, weight)
    else:
        out = torch.bmm(x, weight.transpose(1, 2))
    return out if bias is None else out + bias[:, None, :]


def _shape(nr, *shape):
    return shape if nr is None else (nr, *shape)


class Linear(nn.Module):
    """flax's ``nn.Dense``: ``init`` is ``"lecun"`` (flax's default),
    ``"he"`` or ``"orthogonal"``; zero bias."""

    def __init__(self, in_features, out_features, nr=None, bias=True, init="lecun"):
        super().__init__()
        self.weight = nn.Parameter(INITS[init](torch.empty(_shape(nr, out_features, in_features))))
        self.bias = nn.Parameter(torch.zeros(_shape(nr, out_features))) if bias else None

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` (eps 1e-6)."""

    def __init__(self, features, nr=None):
        super().__init__()
        self.nr = nr
        self.weight = nn.Parameter(torch.ones(_shape(nr, features)))
        self.bias = nn.Parameter(torch.zeros(_shape(nr, features)))

    def forward(self, x):
        x = ensemble_input(x, self.nr)
        return F.layer_norm(x, x.shape[-1:], eps=LAYER_NORM_EPS) * row(self.weight) + row(self.bias)


class PreLNResidualBlock(nn.Module):
    """LayerNorm -> Dense(4h, he) -> relu -> Dense(h, he) + residual."""

    def __init__(self, hidden_dim, nr=None, expansion=4):
        super().__init__()
        self.norm = LayerNorm(hidden_dim, nr)
        self.fc1 = Linear(hidden_dim, hidden_dim * expansion, nr, init="he")
        self.fc2 = Linear(hidden_dim * expansion, hidden_dim, nr, init="he")

    def forward(self, x):
        return x + self.fc2(F.relu(self.fc1(self.norm(x))))


class SimbaEncoder(nn.Module):
    """Dense(h, orthogonal) -> ``nr_blocks`` pre-LN residual blocks -> LayerNorm."""

    def __init__(self, in_features, hidden_dim, nr_blocks, nr=None):
        super().__init__()
        self.embed = Linear(in_features, hidden_dim, nr, init="orthogonal")
        self.blocks = nn.ModuleList(PreLNResidualBlock(hidden_dim, nr) for _ in range(nr_blocks))
        self.norm = LayerNorm(hidden_dim, nr)

    def forward(self, x):
        x = self.embed(x)
        for block in self.blocks:
            x = block(x)
        return self.norm(x)

    def dense_layers(self):
        """The encoder's Dense layers (weight norm treats them as hidden)."""
        return [self.embed] + [fc for block in self.blocks for fc in (block.fc1, block.fc2)]


class BroNetBlock(nn.Module):
    """Dense -> LN -> relu -> Dense -> LN + residual (BRO's trunk)."""

    def __init__(self, hidden_dim, nr=None):
        super().__init__()
        self.fc1, self.norm1 = Linear(hidden_dim, hidden_dim, nr), LayerNorm(hidden_dim, nr)
        self.fc2, self.norm2 = Linear(hidden_dim, hidden_dim, nr), LayerNorm(hidden_dim, nr)

    def forward(self, x):
        return x + self.norm2(self.fc2(F.relu(self.norm1(self.fc1(x)))))


class BroNetEncoder(nn.Module):
    """Dense -> LN -> relu -> ``nr_blocks`` BroNet blocks."""

    def __init__(self, in_features, hidden_dim, nr_blocks, nr=None):
        super().__init__()
        self.embed, self.norm = Linear(in_features, hidden_dim, nr), LayerNorm(hidden_dim, nr)
        self.blocks = nn.ModuleList(BroNetBlock(hidden_dim, nr) for _ in range(nr_blocks))

    def forward(self, x):
        x = F.relu(self.norm(self.embed(x)))
        for block in self.blocks:
            x = block(x)
        return x


def l2_normalize(x, dim=-1, eps=1e-8):
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)


class Scaler(nn.Module):
    """A learnable per-feature scale, stored at ``scale`` and applied as
    ``x * scaler * (init / scale)``."""

    def __init__(self, dim, init=1.0, scale=1.0, nr=None):
        super().__init__()
        self.scaler = nn.Parameter(torch.full(_shape(nr, dim), float(scale)))
        self.factor = init / scale

    def forward(self, x):
        return x * row(self.scaler) * self.factor


class HyperDense(nn.Module):
    """A bias-free Dense whose weight is unit-normalized per output unit in
    the forward pass (its weights live on the hypersphere)."""

    def __init__(self, in_features, out_features, nr=None):
        super().__init__()
        self.weight = nn.Parameter(orthogonal_(torch.empty(_shape(nr, out_features, in_features))))

    def forward(self, x):
        return linear(x, l2_normalize(self.weight, dim=-1))


class HyperEmbedder(nn.Module):
    """Input plus a constant ``c_shift`` channel -> sphere -> HyperDense ->
    Scaler -> sphere (the shift keeps the input's magnitude recoverable)."""

    def __init__(self, in_features, hidden_dim, c_shift=3.0, nr=None):
        super().__init__()
        self.c_shift = c_shift
        self.dense = HyperDense(in_features + 1, hidden_dim, nr)
        s = math.sqrt(2.0 / hidden_dim)
        self.scaler = Scaler(hidden_dim, s, s, nr)

    def forward(self, x):
        x = torch.cat([x, torch.full(x.shape[:-1] + (1,), self.c_shift, dtype=x.dtype, device=x.device)], dim=-1)
        return l2_normalize(self.scaler(self.dense(l2_normalize(x))))


class HyperLERPBlock(nn.Module):
    """SimbaV2's residual block: a hypersphere MLP (relu + 1e-8, output
    re-normalized) merged into the residual by a learnable lerp, the result
    back on the sphere."""

    def __init__(self, hidden_dim, nr_blocks=1, expansion=4, nr=None):
        super().__init__()
        s = math.sqrt(2.0 / hidden_dim) / math.sqrt(expansion)
        self.fc1 = HyperDense(hidden_dim, hidden_dim * expansion, nr)
        self.scaler = Scaler(hidden_dim * expansion, s, s, nr)
        self.fc2 = HyperDense(hidden_dim * expansion, hidden_dim, nr)
        self.alpha = Scaler(hidden_dim, 1.0 / (nr_blocks + 1), 1.0 / math.sqrt(hidden_dim), nr)

    def forward(self, x):
        h = F.relu(self.scaler(self.fc1(x))) + 1e-8
        h = l2_normalize(self.fc2(h))
        return l2_normalize(x + self.alpha(h - x))


class HyperHead(nn.Module):
    """HyperDense -> Scaler -> HyperDense + bias."""

    def __init__(self, hidden_dim, out_dim, nr=None):
        super().__init__()
        self.fc1 = HyperDense(hidden_dim, hidden_dim, nr)
        self.scaler = Scaler(hidden_dim, 1.0, 1.0, nr)
        self.fc2 = HyperDense(hidden_dim, out_dim, nr)
        self.bias = nn.Parameter(torch.zeros(_shape(nr, out_dim)))

    def forward(self, x):
        return self.fc2(self.scaler(self.fc1(x))) + row(self.bias)


class SimbaV2Encoder(nn.Module):
    def __init__(self, in_features, hidden_dim, nr_blocks, c_shift=3.0, nr=None):
        super().__init__()
        self.embedder = HyperEmbedder(in_features, hidden_dim, c_shift, nr)
        self.blocks = nn.ModuleList(HyperLERPBlock(hidden_dim, nr_blocks, nr=nr) for _ in range(nr_blocks))

    def forward(self, x):
        x = self.embedder(x)
        for block in self.blocks:
            x = block(x)
        return x


def set_batch_mesh(modules, mesh):
    """Give every layer of ``modules`` that takes batch statistics
    (``BatchRenorm``, FlashSAC's ``BatchNorm``: a ``batch_mesh``
    attribute) the dp ``mesh`` its train-mode statistics reduce over; at
    dp = 1 none."""
    mesh = mesh if mesh is not None and mesh.dp > 1 else None
    for module in modules:
        for m in module.modules():
            if hasattr(m, "batch_mesh"):
                m.batch_mesh = mesh


def batch_mean_of(x, mesh, dim=-2):
    """``x.mean(dim)``; on a dp ``mesh`` over every rank's rows (a
    differentiable all_reduce: each rank's loss depends on every rank's
    rows through the statistic)."""
    if mesh is None:
        return x.mean(dim=dim)
    from rlx_tpu_torch.parallel.mesh import all_reduce_sum_autograd

    return all_reduce_sum_autograd(x.sum(dim=dim), mesh) / (x.shape[dim] * mesh.dp)


class BatchRenorm(nn.Module):
    """Batch renormalization (CrossQ): batch statistics with the correction
    factors ``r`` (batch over running std, clipped to [1/r_max, r_max]) and
    ``d`` (standardized mean shift, clipped to [-d_max, d_max]), both
    without gradient; plain BN (r = 1, d = 0) until ``steps`` > 1000.  The
    biased batch variance feeds the running variance.  ``train=False``
    normalizes with the running statistics."""

    running_buffers = ("mean", "var", "steps")
    batch_mesh = None   # the dp mesh of the batch statistics (``set_batch_mesh``)

    def __init__(self, features, nr=None, momentum=0.99, eps=1e-3, r_max=3.0, d_max=5.0):
        super().__init__()
        self.nr, self.momentum, self.eps, self.r_max, self.d_max = nr, momentum, eps, r_max, d_max
        self.weight = nn.Parameter(torch.ones(_shape(nr, features)))
        self.bias = nn.Parameter(torch.zeros(_shape(nr, features)))
        self.register_buffer("mean", torch.zeros(_shape(nr, features)))
        self.register_buffer("var", torch.ones(_shape(nr, features)))
        self.register_buffer("steps", torch.zeros(_shape(nr), dtype=torch.int32))
        self.pending = None

    def forward(self, x, train):
        x = ensemble_input(x, self.nr)
        if not train:
            x_hat = (x - row(self.mean)) / torch.sqrt(row(self.var) + self.eps)
        else:
            batch_mean = batch_mean_of(x, self.batch_mesh)
            batch_var = (x.var(dim=-2, unbiased=False) if self.batch_mesh is None
                         else batch_mean_of((x - row(batch_mean)) ** 2, self.batch_mesh))
            batch_std = torch.sqrt(batch_var + self.eps)
            running_std = torch.sqrt(self.var + self.eps)
            warmed_up = (self.steps > 1000).to(x.dtype)
            if warmed_up.ndim:
                warmed_up = warmed_up[:, None]
            with torch.no_grad():
                r = torch.clamp(batch_std / running_std, 1.0 / self.r_max, self.r_max)
                d = torch.clamp((batch_mean - self.mean) / running_std, -self.d_max, self.d_max)
                r = warmed_up * r + (1.0 - warmed_up) * torch.ones_like(r)
                d = warmed_up * d + (1.0 - warmed_up) * torch.zeros_like(d)
            x_hat = ((x - row(batch_mean)) / row(batch_std)) * row(r) + row(d)
            self.pending = (batch_mean.detach(), batch_var.detach())
        return row(self.weight) * x_hat + row(self.bias)

    @torch.no_grad()
    def commit(self):
        batch_mean, batch_var = self.pending
        self.mean.copy_(self.momentum * self.mean + (1.0 - self.momentum) * batch_mean)
        self.var.copy_(self.momentum * self.var + (1.0 - self.momentum) * batch_var)
        self.steps.add_(1)
        self.pending = None


def running_buffers(module):
    """``{name: buffer}`` of the running statistics of every layer of
    ``module`` that keeps them (``running_buffers`` of its class)."""
    return {f"{prefix}.{name}" if prefix else name: getattr(m, name)
            for prefix, m in module.named_modules() for name in getattr(m, "running_buffers", ())}


def commit_batch_stats(module):
    """Apply the batch statistics that each normalization layer of
    ``module`` left pending in its last train-mode forward."""
    for m in module.modules():
        if getattr(m, "pending", None) is not None:
            m.commit()


def discard_batch_stats(module):
    for m in module.modules():
        if hasattr(m, "pending"):
            m.pending = None
