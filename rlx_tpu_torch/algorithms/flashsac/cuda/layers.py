"""FlashSAC's networks (the JAX package's ``flashsac/tpu/layers.py``).

Every linear kernel is bias-free and kept with unit-norm input weights per
output unit by ``project_params``, applied at init and after every
optimizer step; the norm layers' affine parameters are kept on the
sqrt(d) sphere.  The nets are BatchNorm-whitened residual MLPs with an
RMSNorm before the heads:

- ``BatchNorm``: flax's ``nn.BatchNorm(momentum=0.99)``, not
  ``nn.BatchNorm1d``: the running averages move as ``0.99 * running +
  0.01 * batch``, the running variance takes the BIASED batch variance
  (``E[x^2] - E[x]^2``, clipped at 0, as flax computes it), eps 1e-5, and
  ``train`` is an argument of every forward.  A train-mode forward leaves
  its batch statistics pending (``models/layers.commit_batch_stats``);
- ``FlashSACEmbedder``: BatchNorm -> unit linear;
- ``FlashSACBlock``: [unit linear (4h) -> BN -> relu -> unit linear (h) ->
  BN -> relu] + x;
- ``FlashSACTrunk``: embedder -> blocks -> RMSNorm (eps 1e-6);
- ``NormalTanhPolicy``: mean and std heads with biases, the log-std
  tanh-bounded to [log_std_min, log_std_max]; returns (mean, std);
- ``CategoricalValueHead``: logits -> log-softmax over ``nr_atoms``, and the
  expectation over the uniform [v_min, v_max] grid;
- ``FlashSACDoubleCritic``: ``nr_critics`` critics with their own
  parameters and statistics, stacked on a leading axis.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from rlx_tpu_torch.models.layers import batch_mean_of, ensemble_input, linear, orthogonal_, row


def _shape(nr, *shape):
    return shape if nr is None else (nr, *shape)


class UnitLinear(nn.Module):
    """A bias-free linear layer, orthogonal init."""

    def __init__(self, in_features, out_features, nr=None):
        super().__init__()
        self.weight = nn.Parameter(orthogonal_(torch.empty(_shape(nr, out_features, in_features))))

    def forward(self, x):
        return linear(x, self.weight)


class BatchNorm(nn.Module):
    running_buffers = ("mean", "var")
    batch_mesh = None   # the dp mesh of the batch statistics (``set_batch_mesh``)

    def __init__(self, features, nr=None, momentum=0.99, eps=1e-5):
        super().__init__()
        self.nr, self.momentum, self.eps = nr, momentum, eps
        self.weight = nn.Parameter(torch.ones(_shape(nr, features)))
        self.bias = nn.Parameter(torch.zeros(_shape(nr, features)))
        self.register_buffer("mean", torch.zeros(_shape(nr, features)))
        self.register_buffer("var", torch.ones(_shape(nr, features)))
        self.pending = None

    def forward(self, x, train):
        x = ensemble_input(x, self.nr)
        if train:
            mean = batch_mean_of(x, self.batch_mesh)
            var = torch.clamp(batch_mean_of(x * x, self.batch_mesh) - mean * mean, min=0.0)
            self.pending = (mean.detach(), var.detach())
        else:
            mean, var = self.mean, self.var
        return (x - row(mean)) * (torch.rsqrt(row(var) + self.eps) * row(self.weight)) + row(self.bias)

    @torch.no_grad()
    def commit(self):
        mean, var = self.pending
        self.mean.copy_(self.momentum * self.mean + (1.0 - self.momentum) * mean)
        self.var.copy_(self.momentum * self.var + (1.0 - self.momentum) * var)
        self.pending = None


class RMSNorm(nn.Module):
    def __init__(self, features, nr=None, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(_shape(nr, features)))

    def forward(self, x):
        return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + self.eps) * row(self.weight)


class FlashSACEmbedder(nn.Module):
    def __init__(self, in_features, hidden_dim, nr=None):
        super().__init__()
        self.norm = BatchNorm(in_features, nr)
        self.linear = UnitLinear(in_features, hidden_dim, nr)

    def forward(self, x, train):
        return self.linear(self.norm(x, train))


class FlashSACBlock(nn.Module):
    def __init__(self, hidden_dim, nr=None, expansion=4):
        super().__init__()
        self.linear1 = UnitLinear(hidden_dim, hidden_dim * expansion, nr)
        self.norm1 = BatchNorm(hidden_dim * expansion, nr)
        self.linear2 = UnitLinear(hidden_dim * expansion, hidden_dim, nr)
        self.norm2 = BatchNorm(hidden_dim, nr)

    def forward(self, x, train):
        h = F.relu(self.norm1(self.linear1(x), train))
        return F.relu(self.norm2(self.linear2(h), train)) + x


class FlashSACTrunk(nn.Module):
    def __init__(self, in_features, hidden_dim, nr_blocks, nr=None):
        super().__init__()
        self.embedder = FlashSACEmbedder(in_features, hidden_dim, nr)
        self.blocks = nn.ModuleList(FlashSACBlock(hidden_dim, nr) for _ in range(nr_blocks))
        self.norm = RMSNorm(hidden_dim, nr)

    def forward(self, x, train):
        x = self.embedder(x, train)
        for block in self.blocks:
            x = block(x, train)
        return self.norm(x)


class NormalTanhPolicy(nn.Module):
    def __init__(self, in_features, action_dim, log_std_min=-10.0, log_std_max=2.0):
        super().__init__()
        self.mean_weight = nn.Parameter(orthogonal_(torch.empty(action_dim, in_features)))
        self.mean_bias = nn.Parameter(torch.zeros(action_dim))
        self.std_weight = nn.Parameter(orthogonal_(torch.empty(action_dim, in_features)))
        self.std_bias = nn.Parameter(torch.zeros(action_dim))
        self.log_std_min, self.log_std_max = log_std_min, log_std_max

    def forward(self, x):
        mean = F.linear(x, self.mean_weight, self.mean_bias)
        raw = F.linear(x, self.std_weight, self.std_bias)
        log_std = self.log_std_min + (self.log_std_max - self.log_std_min) * 0.5 * (1.0 + torch.tanh(raw))
        return mean, torch.exp(log_std)


class CategoricalValueHead(nn.Module):
    """-> (expected value, log-probabilities over the atoms)."""

    def __init__(self, in_features, nr_atoms, v_min, v_max, nr=None):
        super().__init__()
        self.weight = nn.Parameter(orthogonal_(torch.empty(_shape(nr, nr_atoms, in_features))))
        self.bias = nn.Parameter(torch.zeros(_shape(nr, nr_atoms)))
        self.register_buffer("bins", torch.linspace(v_min, v_max, nr_atoms), persistent=False)

    def forward(self, x):
        log_probs = F.log_softmax(linear(x, self.weight, self.bias), dim=-1)
        return (torch.exp(log_probs) * self.bins).sum(-1), log_probs


class FlashSACPolicy(nn.Module):
    """obs -> (mean, std)."""

    def __init__(self, obs_dim, action_dim, hidden_dim, nr_blocks, log_std_min=-10.0, log_std_max=2.0):
        super().__init__()
        self.trunk = FlashSACTrunk(obs_dim, hidden_dim, nr_blocks)
        self.head = NormalTanhPolicy(hidden_dim, action_dim, log_std_min, log_std_max)

    def forward(self, x, train):
        return self.head(self.trunk(x, train))


class FlashSACDoubleCritic(nn.Module):
    """(obs, action) -> (values ``[nr_critics, B]``, log-probs
    ``[nr_critics, B, nr_atoms]``)."""

    def __init__(self, obs_dim, action_dim, hidden_dim, nr_blocks, nr_atoms, v_min, v_max, nr_critics=2):
        super().__init__()
        self.trunk = FlashSACTrunk(obs_dim + action_dim, hidden_dim, nr_blocks, nr_critics)
        self.head = CategoricalValueHead(hidden_dim, nr_atoms, v_min, v_max, nr_critics)

    def forward(self, obs, action, train):
        return self.head(self.trunk(torch.cat([obs, action], dim=-1), train))


@torch.no_grad()
def project_params(module):
    """In place, the post-update projection:

    - every linear weight (the unit linears, the policy's mean and std
      weights, the value head's weight): unit L2 norm per output unit (a
      norm below 1e-8 left as it is);
    - every RMSNorm scale: ``||scale|| = sqrt(d)``;
    - every BatchNorm (scale, bias) pair: jointly ``||(scale, bias)|| =
      sqrt(d)``;
    - biases and running statistics untouched.
    """
    for m in module.modules():
        if isinstance(m, RMSNorm):
            d = m.weight.shape[-1]
            sq = (m.weight * m.weight).sum(-1, keepdim=True)
            m.weight.mul_(math.sqrt(d) * torch.rsqrt(sq + 1e-8))
        elif isinstance(m, BatchNorm):
            d = m.weight.shape[-1]
            sq = (m.weight * m.weight + m.bias * m.bias).sum(-1, keepdim=True)
            factor = math.sqrt(d) * torch.rsqrt(sq + 1e-8)
            m.weight.mul_(factor)
            m.bias.mul_(factor)
        else:
            for name in ("weight", "mean_weight", "std_weight"):
                weight = getattr(m, name, None)
                if isinstance(weight, nn.Parameter) and isinstance(m, (UnitLinear, NormalTanhPolicy,
                                                                       CategoricalValueHead)):
                    norm = torch.linalg.vector_norm(weight, dim=-1, keepdim=True)
                    weight.div_(torch.where(norm < 1e-8, torch.ones_like(norm), norm))
    return module
