"""Recurrent policy of the memory suite: LSTM, GRU, Mamba-2 and transformer
cells (the JAX package's ``models/recurrent.py``).

obs -> cell-input encoder (Dense, LayerNorm, ELU) -> cell -> LayerNorm, ELU
-> concat or FiLM with the obs encoding -> 512/256/128 torso (LayerNorm
after the first layer, ELU) -> mean head, with a state-independent
``policy_logstd``.  The carry is whatever the cell uses: a ``(c, h)`` tuple
(LSTM), a tensor (GRU), ``{"conv", "ssm"}`` (Mamba-2) or a KV cache per
block ``{"block<b>": {"k", "v", "valid"}}`` (transformer); ``map_carry``
and ``mask_carry`` work on any of them.

``one_step`` runs one env step.  ``sequence`` is the loss's BPTT re-run over
a ``[T, B]`` window with the carry zeroed *before* step t where the episode
ended after step t-1.  It computes what a loop of ``one_step`` over t
computes, but runs everything that does not read the carry once over all
``T * B`` rows (the encoders, the torso, Mamba-2's in-projection, causal
conv and readout) and loops over t only what does: the LSTM and GRU
cells (one fused ``torch.lstm_cell`` / ``torch.gru_cell`` a step) and the
Mamba-2 SSM state (one ``addcmul`` a step), each step's slice taken by
``unbind`` (one backward node for the whole window, where indexing would
add a window-sized gradient a step).  The transformer has no loop:
its window runs as banded-causal attention over the cache and the window.

flax semantics: LayerNorm eps 1e-6, ``nn.gelu`` the tanh approximation,
the LSTM's input kernels without bias (no +1 forget bias), the GRU's ``hr``
and ``hz`` without bias, flax's inits (lecun-normal input kernels,
orthogonal recurrent kernels per gate, zero biases).  The attention's
products are elementwise products and sums, f32 whatever the TF32 setting:
the JAX package runs them at ``Precision.HIGHEST``.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rlx_tpu_torch.models.layers import orthogonal_
from rlx_tpu_torch.models.mlp import LAYER_NORM_EPS, _lecun_linear, _orthogonal_linear, lecun_normal_

# the value a masked attention logit takes (the JAX package's; the current
# token is always valid, so no row is masked whole)
MASKED_LOGIT = -1e9


def map_carry(fn, carry):
    """``fn`` applied to every tensor of a carry (dicts and tuples kept)."""
    if isinstance(carry, dict):
        return {k: map_carry(fn, v) for k, v in carry.items()}
    if isinstance(carry, (tuple, list)):
        return type(carry)(map_carry(fn, v) for v in carry)
    return fn(carry)


def mask_carry(carry, done):
    """Zero a carry per env where ``done`` (``[B]``; any leaf rank)."""
    keep = 1.0 - done.float()
    return map_carry(lambda c: c * keep.reshape((-1,) + (1,) * (c.ndim - 1)).to(c.dtype), carry)


def _layer_norm(features):
    return nn.LayerNorm(features, eps=LAYER_NORM_EPS)


def _segments(done_prev):
    """Episode segment ids ``[T, B]``: the cumsum of the previous step's
    dones (0 until the first reset in the window)."""
    return torch.cumsum(done_prev.to(torch.int32), dim=0)


def _window_valid(seg, nr_cached, cache_valid=None):
    """``[T, W, B]`` validity of the W = nr_cached + 1 slots a step reads,
    oldest first (slot W-1 the step's own token): slot l of step t is
    source s = t - nr_cached + l.  An in-window source is valid when it is
    in the step's episode segment; a cached one (s < 0) when the cache slot
    is valid and no reset came since the window started."""
    T, B = seg.shape
    W = nr_cached + 1
    src = torch.arange(T, device=seg.device)[:, None] + torch.arange(W, device=seg.device)[None] - nr_cached
    in_window = (src >= 0)[:, :, None]
    same_seg = seg[src.clamp(0, T - 1)] == seg[:, None, :]
    no_reset_yet = (seg == 0)[:, None, :]
    if cache_valid is None:
        from_cache = no_reset_yet.expand(T, W, B)
    else:
        padded = torch.cat([cache_valid.transpose(0, 1), cache_valid.new_zeros(T, B)], dim=0)
        from_cache = (padded[src + nr_cached] > 0.5) & no_reset_yet
    return torch.where(in_window, same_seg, from_cache)


def _windows(cached, x_seq):
    """``[T, W, B, F]``: for each step the last W = len(cached) + 1 tokens
    of the timeline ``cached`` (``[B, W-1, F]``) followed by ``x_seq``
    (``[T, B, F]``)."""
    T, W = x_seq.shape[0], cached.shape[1] + 1
    timeline = torch.cat([cached.transpose(0, 1), x_seq], dim=0)
    idx = torch.arange(T, device=x_seq.device)[:, None] + torch.arange(W, device=x_seq.device)[None]
    return timeline[idx]


class LSTMCell(nn.Module):
    """flax's ``OptimizedLSTMCell``: gates i, f, g, o (rows of ``weight_ih``
    / ``weight_hh`` in that order), the input product without bias, the
    recurrent one with ``bias_hh``; ``c' = f c + i g``, ``h' = o tanh(c')``;
    carry ``(c, h)``."""

    def __init__(self, in_features, features):
        super().__init__()
        self.features = features
        self.weight_ih = nn.Parameter(lecun_normal_(torch.empty(4 * features, in_features)))
        self.weight_hh = nn.Parameter(torch.empty(4 * features, features))
        orthogonal_(self.weight_hh.data.view(4, features, features))
        self.bias_hh = nn.Parameter(torch.zeros(4 * features))
        # a zero input bias (not a parameter): torch's fused CUDA cell gives
        # the recurrent bias its gradient only when both biases are passed
        self.register_buffer("zero_bias_ih", torch.zeros(4 * features), persistent=False)

    def initialize_carry(self, nr_envs, **like):
        zeros = torch.zeros(nr_envs, self.features, **like)
        return (zeros, zeros.clone())

    def forward(self, carry, x):
        c, h = carry
        h, c = torch.lstm_cell(x, (h, c), self.weight_ih, self.weight_hh, self.zero_bias_ih, self.bias_hh)
        return (c, h), h

    def sequence(self, init_carry, x_seq, done_prev):
        keep = (1.0 - done_prev.float())[..., None]
        carry, outs = init_carry, []
        for keep_t, x_t in zip(keep.unbind(0), x_seq.unbind(0)):
            carry, h = self(tuple(c * keep_t for c in carry), x_t)
            outs.append(h)
        return torch.stack(outs)


class GRUCell(nn.Module):
    """flax's ``GRUCell``: ``r = sigmoid(ir x + hr h)``, ``z = sigmoid(iz x
    + hz h)``, ``n = tanh(in x + r (hn h))``, ``h' = (1 - z) n + z h``; rows
    of ``weight_ih`` / ``weight_hh`` in the order r, z, n; ``ir``, ``iz``,
    ``in`` and ``hn`` with bias, ``hr`` and ``hz`` without (torch's
    ``gru_cell`` with ``b_hh = [0, 0, bias_hn]``)."""

    def __init__(self, in_features, features):
        super().__init__()
        self.features = features
        self.weight_ih = nn.Parameter(lecun_normal_(torch.empty(3 * features, in_features)))
        self.bias_ih = nn.Parameter(torch.zeros(3 * features))
        self.weight_hh = nn.Parameter(torch.empty(3 * features, features))
        orthogonal_(self.weight_hh.data.view(3, features, features))
        self.bias_hn = nn.Parameter(torch.zeros(features))

    def initialize_carry(self, nr_envs, **like):
        return torch.zeros(nr_envs, self.features, **like)

    def _bias_hh(self):
        return torch.cat([self.bias_hn.new_zeros(2 * self.features), self.bias_hn])

    def forward(self, carry, x, bias_hh=None):
        bias_hh = self._bias_hh() if bias_hh is None else bias_hh
        h = torch.gru_cell(x, carry, self.weight_ih, self.weight_hh, self.bias_ih, bias_hh)
        return h, h

    def sequence(self, init_carry, x_seq, done_prev):
        keep = (1.0 - done_prev.float())[..., None]
        bias_hh = self._bias_hh()
        h, outs = init_carry, []
        for keep_t, x_t in zip(keep.unbind(0), x_seq.unbind(0)):
            h, _ = self(h * keep_t, x_t, bias_hh)
            outs.append(h)
        return torch.stack(outs)


class Mamba2Cell(nn.Module):
    """Mamba-2-style cell: pre-LN, in-projection to ``(u, z)``, a depthwise
    causal conv over the last ``conv_kernel`` tokens, SiLU, a selective
    diagonal SSM (``dA = exp(softplus(dt_raw + dt_bias) * -exp(A_log))``,
    ``dB u`` input, ``C`` readout, ``D`` skip), a SiLU gate on ``z``, the
    out-projection and the residual.  Carry ``{"conv": [B, K-1, D],
    "ssm": [B, D, N]}``, D = 2 * features."""

    def __init__(self, features, state_dim=16, expand=2, conv_kernel=4, dt_min=1e-3, dt_max=0.1):
        super().__init__()
        inner = features * expand
        self.inner, self.state_dim, self.conv_size = inner, state_dim, conv_kernel
        self.norm = _layer_norm(features)
        self.in_proj = _lecun_linear(features, 2 * inner)
        self.conv_kernel = nn.Parameter(0.02 * torch.randn(conv_kernel, inner))
        self.conv_bias = nn.Parameter(torch.zeros(inner))
        self.x_proj = _lecun_linear(inner, inner + 2 * state_dim)
        dt = torch.exp(torch.empty(inner).uniform_(math.log(dt_min), math.log(dt_max)))
        self.dt_bias = nn.Parameter(dt + torch.log(-torch.expm1(-dt)))   # softplus^-1(dt)
        self.A_log = nn.Parameter(torch.log(torch.arange(1, state_dim + 1, dtype=torch.float32)).repeat(inner, 1))
        self.D = nn.Parameter(torch.ones(inner))
        self.out_proj = _lecun_linear(inner, features)

    def initialize_carry(self, nr_envs, **like):
        return {"conv": torch.zeros(nr_envs, self.conv_size - 1, self.inner, **like),
                "ssm": torch.zeros(nr_envs, self.inner, self.state_dim, **like)}

    def _ssm_inputs(self, u):
        """(u after the SiLU, dA, dB u, C) from the conv's output."""
        inner, N = self.inner, self.state_dim
        u = F.silu(u)
        params = self.x_proj(u)
        dt_raw, b, c = params[..., :inner], params[..., inner:inner + N], params[..., inner + N:]
        dt = F.softplus(dt_raw + self.dt_bias)
        dA = torch.exp(dt[..., None] * -torch.exp(self.A_log))
        dBu = dt[..., None] * b[..., None, :] * u[..., None]
        return u, dA, dBu, c

    def _readout(self, ssm, c, u, z, residual):
        y = (ssm * c[..., None, :]).sum(-1) + self.D * u
        return residual + self.out_proj(y * F.silu(z))

    def forward(self, carry, x):
        u, z = self.in_proj(self.norm(x)).chunk(2, dim=-1)
        conv_in = torch.cat([carry["conv"], u[:, None, :]], dim=1)          # [B, K, D]
        conv = (conv_in * self.conv_kernel).sum(1) + self.conv_bias
        u, dA, dBu, c = self._ssm_inputs(conv)
        ssm = dA * carry["ssm"] + dBu
        return {"conv": conv_in[:, 1:], "ssm": ssm}, self._readout(ssm, c, u, z, x)

    def sequence(self, init_carry, x_seq, done_prev):
        u, z = self.in_proj(self.norm(x_seq)).chunk(2, dim=-1)             # [T, B, D]
        # the conv's K taps for every step at once: the taps of an earlier
        # episode segment (or of the carry after a reset) are the zeros a
        # masked carry would hold
        K = self.conv_size
        valid = _window_valid(_segments(done_prev), K - 1).to(u.dtype)      # [T, K, B]
        taps = _windows(init_carry["conv"], u) * valid[..., None]           # [T, K, B, D]
        conv = (taps * self.conv_kernel[None, :, None, :]).sum(1) + self.conv_bias
        u, dA, dBu, c = self._ssm_inputs(conv)
        dA = dA * (1.0 - done_prev.float())[..., None, None]               # the reset before step t
        ssm, states = init_carry["ssm"], []
        for dA_t, dBu_t in zip(dA.unbind(0), dBu.unbind(0)):
            ssm = torch.addcmul(dBu_t, dA_t, ssm)
            states.append(ssm)
        return self._readout(torch.stack(states), c, u, z, x_seq)


class TransformerBlock(nn.Module):
    """Pre-LN attention + MLP block with a streaming path (one token against
    a ``[B, L-1, F]`` KV cache) and a parallel path (a whole window as
    banded-causal attention over the cache and the window, with episode
    segments), both adding a learned relative-age bias ``[H, L]`` (slot L-1
    the current token) initialized with ALiBi slopes: head h starts
    attending mostly to the last ~2^h tokens."""

    def __init__(self, features, context_len=16, nr_heads=4, mlp_expand=4):
        super().__init__()
        self.features, self.context_len, self.nr_heads = features, context_len, nr_heads
        self.head_dim = features // nr_heads
        self.ln1 = _layer_norm(features)
        self.wq, self.wk, self.wv, self.wo = (_lecun_linear(features, features) for _ in range(4))
        self.ln2 = _layer_norm(features)
        self.mlp1 = _lecun_linear(features, features * mlp_expand)
        self.mlp2 = _lecun_linear(features * mlp_expand, features)
        ages = np.arange(context_len - 1, -1, -1, dtype=np.float32)
        slopes = 2.0 ** (-np.arange(1, nr_heads + 1, dtype=np.float32))
        self.age_bias = nn.Parameter(torch.tensor(-slopes[:, None] * ages[None, :]))

    def _mlp(self, x):
        return x + self.mlp2(F.gelu(self.mlp1(self.ln2(x)), approximate="tanh"))

    def _attend(self, q, keys, values, valid):
        """q ``[..., H, d]``, keys / values ``[..., L, H, d]``, valid ``[..., L]``
        -> ``[..., H * d]``; products and sums in f32."""
        logits = (q[..., None, :, :] * keys).sum(-1).transpose(-1, -2) / math.sqrt(self.head_dim)
        logits = torch.where(valid[..., None, :], logits + self.age_bias, MASKED_LOGIT)
        attn = torch.softmax(logits, dim=-1)                                   # [..., H, L]
        out = (attn.transpose(-1, -2)[..., None] * values).sum(-3)             # [..., H, d]
        return out.flatten(-2)

    def streaming(self, cache, x):
        """One token: x ``[B, F]``, cache -> (new cache, out ``[B, F]``)."""
        B, H, d = x.shape[0], self.nr_heads, self.head_dim
        h = self.ln1(x)
        q, k, v = self.wq(h), self.wk(h), self.wv(h)
        keys = torch.cat([cache["k"], k[:, None]], dim=1)                      # [B, L, F]
        values = torch.cat([cache["v"], v[:, None]], dim=1)
        valid = torch.cat([cache["valid"], torch.ones_like(cache["valid"][:, :1])], dim=1)
        L = keys.shape[1]
        out = self._attend(q.reshape(B, H, d), keys.reshape(B, L, H, d), values.reshape(B, L, H, d), valid > 0.5)
        x = self._mlp(x + self.wo(out))
        return {"k": keys[:, 1:], "v": values[:, 1:], "valid": valid[:, 1:]}, x

    def parallel(self, cache, x_seq, seg):
        """A window: x_seq ``[T, B, F]``, seg ``[T, B]`` episode segment ids
        -> ``[T, B, F]``, what ``streaming`` over t with the cache masked at
        each reset gives."""
        T, B, F_ = x_seq.shape
        L, H, d = self.context_len, self.nr_heads, self.head_dim
        h = self.ln1(x_seq)
        q, k, v = self.wq(h), self.wk(h), self.wv(h)
        keys = _windows(cache["k"], k).reshape(T, L, B, H, d).transpose(1, 2)    # [T, B, L, H, d]
        values = _windows(cache["v"], v).reshape(T, L, B, H, d).transpose(1, 2)
        valid = _window_valid(seg, L - 1, cache["valid"]).transpose(1, 2)        # [T, B, L]
        out = self._attend(q.reshape(T, B, H, d), keys, values, valid)
        return self._mlp(x_seq + self.wo(out))


class TransformerCell(nn.Module):
    """Sliding-window causal self-attention over the last ``context_len``
    tokens as a streaming cell: ``nr_blocks`` blocks, a KV cache each;
    ``sequence`` runs the blocks' parallel path."""

    def __init__(self, features, context_len=16, nr_heads=4, nr_blocks=2, mlp_expand=4):
        super().__init__()
        self.features, self.context_len = features, context_len
        self.blocks = nn.ModuleList(TransformerBlock(features, context_len, nr_heads, mlp_expand)
                                    for _ in range(nr_blocks))

    def initialize_carry(self, nr_envs, **like):
        L = self.context_len - 1
        return {f"block{b}": {"k": torch.zeros(nr_envs, L, self.features, **like),
                              "v": torch.zeros(nr_envs, L, self.features, **like),
                              "valid": torch.zeros(nr_envs, L, **like)}
                for b in range(len(self.blocks))}

    def forward(self, carry, x):
        new_carry = {}
        for b, block in enumerate(self.blocks):
            new_carry[f"block{b}"], x = block.streaming(carry[f"block{b}"], x)
        return new_carry, x

    def sequence(self, init_carry, x_seq, done_prev):
        seg = _segments(done_prev)
        for b, block in enumerate(self.blocks):
            x_seq = block.parallel(init_carry[f"block{b}"], x_seq, seg)
        return x_seq


class RecurrentPolicy(nn.Module):
    """obs -> (mean, logstd) through a recurrent cell ``cell_type`` in
    ``lstm``, ``gru``, ``mamba2``, ``transformer``.  ``hidden_dim`` is the
    LSTM's / GRU's width; Mamba-2 and the transformer run at
    ``obs_encoding_dim``.  ``observation_indices`` picks the policy's
    observation columns (an env's ``policy_observation_indices``)."""

    def __init__(self, obs_dim, action_dim, cell_type="lstm", std_dev=1.0, obs_encoding_dim=128, hidden_dim=64,
                 combine_method="concat", share_encoder=False, observation_indices=None, cell_state_dim=16,
                 cell_conv_kernel=4, cell_context_len=16, cell_nr_heads=4, cell_nr_blocks=2):
        super().__init__()
        if combine_method not in ("concat", "film"):
            raise ValueError(f"unknown combine_method {combine_method!r}")
        self.cell_type, self.combine_method, self.share_encoder = cell_type, combine_method, share_encoder
        if observation_indices is not None:
            self.register_buffer("observation_indices", torch.as_tensor(list(observation_indices)),
                                 persistent=False)
            obs_dim = len(observation_indices)
        else:
            self.observation_indices = None
        E = obs_encoding_dim
        gain = math.sqrt(2)
        self.cell_obs_encoder = _orthogonal_linear(obs_dim, E, gain)
        self.cell_obs_ln = _layer_norm(E)
        if not share_encoder:
            self.obs_encoder = _orthogonal_linear(obs_dim, E, gain)
            self.obs_ln = _layer_norm(E)
        if cell_type == "lstm":
            self.cell, cell_out = LSTMCell(E, hidden_dim), hidden_dim
        elif cell_type == "gru":
            self.cell, cell_out = GRUCell(E, hidden_dim), hidden_dim
        elif cell_type == "mamba2":
            self.cell, cell_out = Mamba2Cell(E, cell_state_dim, conv_kernel=cell_conv_kernel), E
        elif cell_type == "transformer":
            self.cell, cell_out = TransformerCell(E, cell_context_len, cell_nr_heads, cell_nr_blocks), E
        else:
            raise ValueError(f"unknown cell_type {cell_type!r}")
        self.cell_ln = _layer_norm(cell_out)
        if combine_method == "film":
            self.film_gamma = _orthogonal_linear(cell_out, E, gain)
            self.film_beta = _orthogonal_linear(cell_out, E, gain)
            torso_in = E
        else:
            torso_in = E + cell_out
        self.torso_dense1 = _orthogonal_linear(torso_in, 512, gain)
        self.torso_ln1 = _layer_norm(512)
        self.torso_dense2 = _orthogonal_linear(512, 256, gain)
        self.torso_dense3 = _orthogonal_linear(256, 128, gain)
        self.mean_head = _orthogonal_linear(128, action_dim, 0.01)
        self.policy_logstd = nn.Parameter(torch.full((1, action_dim), math.log(std_dev)))

    def initialize_carry(self, nr_envs):
        """A zero carry on the policy's device, in its parameters' type."""
        return self.cell.initialize_carry(nr_envs, device=self.policy_logstd.device, dtype=self.policy_logstd.dtype)

    def _select(self, obs):
        return obs if self.observation_indices is None else obs[..., self.observation_indices]

    def _encode_cell_input(self, obs):
        return F.elu(self.cell_obs_ln(self.cell_obs_encoder(self._select(obs))))

    def _encode_obs(self, obs, cell_in):
        if self.share_encoder:
            return cell_in
        return F.elu(self.obs_ln(self.obs_encoder(self._select(obs))))

    def _decode(self, obs_latent, cell_out):
        h = F.elu(self.cell_ln(cell_out))
        if self.combine_method == "concat":
            torso_in = torch.cat([obs_latent, h], dim=-1)
        else:
            torso_in = obs_latent * self.film_gamma(h) + self.film_beta(h)
        x = F.elu(self.torso_ln1(self.torso_dense1(torso_in)))
        x = F.elu(self.torso_dense2(x))
        x = F.elu(self.torso_dense3(x))
        return self.mean_head(x), self.policy_logstd

    def one_step(self, obs, carry):
        """obs ``[B, obs]``, carry -> (mean, logstd, next carry)."""
        cell_in = self._encode_cell_input(obs)
        carry, hidden = self.cell(carry, cell_in)
        mean, logstd = self._decode(self._encode_obs(obs, cell_in), hidden)
        return mean, logstd, carry

    def sequence(self, obs_seq, done_seq, init_carry):
        """BPTT re-run: obs_seq ``[T, B, obs]``, done_seq ``[T, B]`` (done
        after step t), init_carry the carry before step 0 -> (mean ``[T, B,
        A]``, logstd)."""
        done_prev = torch.cat([torch.zeros_like(done_seq[:1]), done_seq[:-1]], dim=0).float()
        cell_in = self._encode_cell_input(obs_seq)
        hidden = self.cell.sequence(init_carry, cell_in, done_prev)
        return self._decode(self._encode_obs(obs_seq, cell_in), hidden)
