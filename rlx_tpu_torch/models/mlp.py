"""MLP policy and critic networks.

Init follows the JAX package: for PPO's nets orthogonal kernels with
sqrt(2) gain on the trunk, 0.01 on the policy head, 1.0 on the value head,
zero biases, and a state-independent ``policy_logstd`` of shape
``(1, action_dim)``; for the off-policy nets (``orthogonal_init=False``)
flax's default Dense init, lecun normal kernels and zero biases.

``compute_dtype`` is the trunk's compute type (parameters stay float32):
with bfloat16 the trunk's products run in bfloat16, while the heads, the
distribution math and Adam stay float32.  Without it the trunk computes in
its input's type.  LayerNorm uses eps=1e-6 (flax's default; torch's is
1e-5).

Image observations ``[..., H, W, C]`` (``image_shape`` given) go through
``NatureCNN`` in place of the MLP trunk, as the JAX nets' ``vision``
branch: in float32 whatever ``compute_dtype`` says, and reading the whole
image (observation indices apply to flat observations only).
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
# stddev of a unit normal truncated to [-2, 2] (flax's variance_scaling)
TRUNCATED_NORMAL_STDDEV = 0.87962566103423978


def _orthogonal_linear(in_features, out_features, gain):
    layer = nn.Linear(in_features, out_features)
    nn.init.orthogonal_(layer.weight, gain=gain)
    nn.init.zeros_(layer.bias)
    return layer


def lecun_normal_(weight):
    """flax's default kernel init in place: a normal truncated at two
    standard deviations, scaled to variance 1/fan_in (fan_in is the last
    axis of a ``[..., out, in]`` weight)."""
    std = math.sqrt(1.0 / weight.shape[-1]) / TRUNCATED_NORMAL_STDDEV
    return nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std)


def _lecun_linear(in_features, out_features):
    layer = nn.Linear(in_features, out_features)
    lecun_normal_(layer.weight)
    nn.init.zeros_(layer.bias)
    return layer


def _lecun_conv(in_channels, out_channels, kernel_size, stride):
    """flax ``nn.Conv``'s default init: lecun normal over the fan-in
    ``in_channels * kh * kw``, zero bias."""
    layer = nn.Conv2d(in_channels, out_channels, kernel_size, stride)
    std = math.sqrt(1.0 / (in_channels * kernel_size * kernel_size)) / TRUNCATED_NORMAL_STDDEV
    nn.init.trunc_normal_(layer.weight, std=std, a=-2.0 * std, b=2.0 * std)
    nn.init.zeros_(layer.bias)
    return layer


class NatureCNN(nn.Module):
    """The DQN Nature CNN over ``[..., H, W, C]`` images (the JAX package's
    ``NatureCNN``): ``x / 255`` in float32 (uint8 replay rows and the envs'
    float32 frames alike), then conv 8x8/4 to 32, conv 4x4/2 to 64, conv
    3x3/1 to 64, each VALID and ReLU (84 -> 20 -> 9 -> 7), flatten and Dense
    to ``features`` with ReLU.

    The images stay NHWC as flax has them: conv2d gets ``permute(0, 3, 1,
    2)``, an NCHW-shaped view with channels-last strides, and the last
    feature map is permuted back before the flatten, so its order is
    flax's (H, W, C) and ``Dense_0``'s kernel carries over as a plain
    transpose (``convert.nature_cnn_state_dict``)."""

    LAYERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))   # (out channels, kernel, stride)

    def __init__(self, image_shape, features=512):
        super().__init__()
        height, width, channels = image_shape
        convs = []
        for out_channels, kernel, stride in self.LAYERS:
            convs.append(_lecun_conv(channels, out_channels, kernel, stride))
            height, width, channels = (height - kernel) // stride + 1, (width - kernel) // stride + 1, out_channels
        self.convs = nn.ModuleList(convs)
        self.dense = _lecun_linear(height * width * channels, features)
        self.features = features

    def forward(self, x):
        batch_shape = x.shape[:-3]
        # x / 255 in float32, then in the parameters' type (float64 in the
        # parity tests), as flax promotes the float32 frames to its params'
        x = (x.to(torch.float32) / 255.0).to(self.dense.weight.dtype)
        x = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        x = x.permute(0, 2, 3, 1).reshape(batch_shape + (-1,))
        return F.relu(self.dense(x))


def make_trunk(obs_dim, hidden_sizes, activation, layer_norm=False, compute_dtype=None, image_shape=None,
               **mlp_options):
    """(trunk, its output width): ``NatureCNN`` over ``image_shape`` when
    given, else the ``MLP``."""
    if image_shape is not None:
        trunk = NatureCNN(image_shape)
        return trunk, trunk.features
    return MLP(obs_dim, hidden_sizes, activation, layer_norm, compute_dtype=compute_dtype,
               **mlp_options), hidden_sizes[-1]


def observation_width(observation_shape, indices):
    """Input width of a net that reads the observation columns ``indices``
    (all of a flat observation when ``indices`` is None)."""
    return math.prod(observation_shape) if indices is None else len(indices)


def select_observations(module, indices):
    """Feed ``module`` only the observation columns ``indices`` (an env's
    ``policy_observation_indices`` or ``critic_observation_indices``), as
    the JAX nets' ``observation_indices`` field does: a forward pre-hook
    gathers them from the first argument, so the first layer is
    ``len(indices)`` wide.  The indices are a buffer outside
    ``state_dict()``; ``None`` leaves ``module`` as it is."""
    if indices is None:
        return module
    index = torch.as_tensor(indices, dtype=torch.long).cpu()
    module.register_buffer("observation_indices", index, persistent=False)
    module.register_forward_pre_hook(_gather_observations)
    return module


def _gather_observations(module, args):
    return (args[0][..., module.observation_indices],) + tuple(args[1:])


class MLP(nn.Module):
    """Dense -> (LayerNorm after the first Dense, or with ``layer_norm_all``
    after every Dense) -> activation, per layer."""

    def __init__(self, in_features, hidden_sizes, activation="tanh", layer_norm=False,
                 kernel_gain=math.sqrt(2), compute_dtype=None, orthogonal_init=True,
                 layer_norm_all=False):
        super().__init__()
        sizes = [in_features] + list(hidden_sizes)
        make = (lambda a, b: _orthogonal_linear(a, b, kernel_gain)) if orthogonal_init else _lecun_linear
        self.layers = nn.ModuleList(make(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        self.norm = (nn.LayerNorm(hidden_sizes[0], eps=LAYER_NORM_EPS)
                     if layer_norm and not layer_norm_all else None)
        self.norms = (nn.ModuleList(nn.LayerNorm(size, eps=LAYER_NORM_EPS) for size in hidden_sizes)
                      if layer_norm_all else None)
        self.activation = ACTIVATIONS[activation]
        self.compute_dtype = compute_dtype

    def _norm_after(self, i):
        if self.norms is not None:
            return self.norms[i]
        return self.norm if i == 0 else None

    def forward(self, x):
        dtype = self.compute_dtype or x.dtype
        x = x.to(dtype)
        for i, layer in enumerate(self.layers):
            x = F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype))
            norm = self._norm_after(i)
            if norm is not None:
                # statistics in float32 (or the input's wider type), output
                # in the compute type
                x = F.layer_norm(x.to(torch.promote_types(dtype, torch.float32)), norm.normalized_shape,
                                 norm.weight, norm.bias, norm.eps).to(dtype)
            x = self.activation(x)
        return x.float() if self.compute_dtype else x


class GaussianPolicy(nn.Module):
    """obs -> (mean, logstd) with a state-independent logstd parameter."""

    def __init__(self, obs_dim, action_dim, hidden_sizes, activation="tanh", layer_norm=False,
                 std_dev=1.0, compute_dtype=None, image_shape=None):
        super().__init__()
        self.trunk, width = make_trunk(obs_dim, hidden_sizes, activation, layer_norm, compute_dtype, image_shape)
        self.mean = _orthogonal_linear(width, action_dim, 0.01)
        self.policy_logstd = nn.Parameter(torch.full((1, action_dim), math.log(std_dev)))

    def forward(self, x):
        return self.mean(self.trunk(x)), self.policy_logstd


class CategoricalPolicy(nn.Module):
    """obs -> logits over ``nr_actions`` discrete actions: the same trunk as
    ``GaussianPolicy`` and an ``orthogonal(0.01)`` head, which runs in f32
    after a bf16 trunk."""

    def __init__(self, obs_dim, nr_actions, hidden_sizes, activation="tanh", layer_norm=False,
                 compute_dtype=None, image_shape=None):
        super().__init__()
        self.trunk, width = make_trunk(obs_dim, hidden_sizes, activation, layer_norm, compute_dtype, image_shape)
        self.logits = _orthogonal_linear(width, nr_actions, 0.01)

    def forward(self, x):
        return self.logits(self.trunk(x))


class VCritic(nn.Module):
    """obs -> state value [..., 1]."""

    def __init__(self, obs_dim, hidden_sizes, activation="tanh", layer_norm=False,
                 compute_dtype=None, image_shape=None):
        super().__init__()
        self.trunk, width = make_trunk(obs_dim, hidden_sizes, activation, layer_norm, compute_dtype, image_shape)
        self.value = _orthogonal_linear(width, 1, 1.0)

    def forward(self, x):
        return self.value(self.trunk(x))


class DeterministicTanhPolicy(nn.Module):
    """DDPG/TD3 policy: obs -> tanh(Dense(trunk)) in [-1, 1]."""

    def __init__(self, obs_dim, action_dim, hidden_sizes, activation="relu", layer_norm=False):
        super().__init__()
        self.trunk = MLP(obs_dim, hidden_sizes, activation, layer_norm, orthogonal_init=False)
        self.head = _lecun_linear(hidden_sizes[-1], action_dim)

    def forward(self, x):
        return torch.tanh(self.head(self.trunk(x)))


class SquashedGaussianPolicy(nn.Module):
    """SAC policy: obs -> (mean, log_std), both Dense heads on a lecun-init
    trunk, ``log_std`` clamped to ``[log_std_min, log_std_max]`` (zero
    gradient outside, as ``jnp.clip``); the tanh squash and its log-prob
    are in ``models/distributions.py``."""

    def __init__(self, obs_dim, action_dim, hidden_sizes, activation="elu", layer_norm=True,
                 log_std_min=-20.0, log_std_max=2.0):
        super().__init__()
        self.trunk = MLP(obs_dim, hidden_sizes, activation, layer_norm, orthogonal_init=False)
        self.mean = _lecun_linear(hidden_sizes[-1], action_dim)
        self.log_std = _lecun_linear(hidden_sizes[-1], action_dim)
        self.log_std_min, self.log_std_max = log_std_min, log_std_max

    def forward(self, x):
        x = self.trunk(x)
        return self.mean(x), torch.clamp(self.log_std(x), self.log_std_min, self.log_std_max)


class EntropyCoefficient(nn.Module):
    """SAC's learnable temperature: a scalar ``log_alpha`` parameter,
    initialized to ``log(init_ent_coef)``; ``forward()`` is ``exp(log_alpha)``."""

    def __init__(self, init_ent_coef=1.0):
        super().__init__()
        self.log_alpha = nn.Parameter(torch.full((), math.log(init_ent_coef)))

    def forward(self):
        return torch.exp(self.log_alpha)


class BatchedLinear(nn.Module):
    """``nr`` independent Dense layers: weight ``[nr, out, in]``, bias
    ``[nr, out]``; one batched product maps ``[B, in]`` (shared input) or
    ``[nr, B, in]`` to ``[nr, B, out]``."""

    def __init__(self, nr, in_features, out_features):
        super().__init__()
        self.weight = nn.Parameter(lecun_normal_(torch.empty(nr, out_features, in_features)))
        self.bias = nn.Parameter(torch.zeros(nr, out_features))

    def forward(self, x):
        if x.ndim == 2:
            return torch.einsum("bi,noi->nbo", x, self.weight) + self.bias[:, None, :]
        return torch.baddbmm(self.bias[:, None, :], x, self.weight.transpose(1, 2))


class VectorQCritic(nn.Module):
    """An ensemble of ``nr_critics`` Q critics, (obs, action) -> ``[nr_critics,
    B, output_dim]``, with flax's default init and each member's weights
    stacked on a leading axis (the JAX package's ``nn.vmap``-ed ``QCritic``):
    Dense -> (LayerNorm after the first Dense) -> activation per layer, then
    a Dense head.  With ``dropout_rate`` > 0 (DroQ) every hidden layer is
    Dense -> Dropout -> LayerNorm -> activation instead; each member drops
    its own units, ``dropout_masks`` (one boolean ``[nr_critics, B, size]``
    keep-mask per hidden layer) are drawn from ``generator`` unless given,
    and a kept unit is scaled by ``1 / (1 - dropout_rate)`` as flax's
    ``nn.Dropout``.  With ``layer_norm_all`` (FastMPO's critic) every hidden
    layer is Dense -> LayerNorm -> activation, the norms' parameters in
    ``norm_weights`` / ``norm_biases`` as the dropout critic's."""

    def __init__(self, obs_dim, action_dim, hidden_sizes, nr_critics=2, activation="relu",
                 layer_norm=False, output_dim=1, dropout_rate=0.0, layer_norm_all=False):
        super().__init__()
        sizes = [obs_dim + action_dim] + list(hidden_sizes)
        self.layers = nn.ModuleList(
            BatchedLinear(nr_critics, a, b) for a, b in zip(sizes[:-1], sizes[1:])
        )
        self.dropout_rate = dropout_rate
        self.layer_norm_all = layer_norm_all
        if dropout_rate > 0.0 or layer_norm_all:
            self.norm_weights = nn.ParameterList(torch.ones(nr_critics, size) for size in hidden_sizes)
            self.norm_biases = nn.ParameterList(torch.zeros(nr_critics, size) for size in hidden_sizes)
        elif layer_norm:
            self.norm_weight = nn.Parameter(torch.ones(nr_critics, hidden_sizes[0]))
            self.norm_bias = nn.Parameter(torch.zeros(nr_critics, hidden_sizes[0]))
        self.layer_norm = layer_norm
        self.activation = ACTIVATIONS[activation]
        self.head = BatchedLinear(nr_critics, hidden_sizes[-1], output_dim)

    def forward(self, obs, action, dropout_masks=None, generator=None):
        x = torch.cat([obs, action], dim=-1)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if self.dropout_rate > 0.0:
                keep = 1.0 - self.dropout_rate
                if dropout_masks is not None:
                    mask = dropout_masks[i]
                elif generator is not None:
                    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
                else:
                    raise ValueError("a dropout critic needs dropout_masks or a generator")
                x = torch.where(mask, x / keep, 0.0)
            if self.dropout_rate > 0.0 or self.layer_norm_all:
                x = F.layer_norm(x, x.shape[-1:], eps=LAYER_NORM_EPS)
                x = x * self.norm_weights[i][:, None, :] + self.norm_biases[i][:, None, :]
            elif i == 0 and self.layer_norm:
                x = F.layer_norm(x, x.shape[-1:], eps=LAYER_NORM_EPS)
                x = x * self.norm_weight[:, None, :] + self.norm_bias[:, None, :]
            x = self.activation(x)
        return self.head(x)


class QCritic(VectorQCritic):
    """A single Q critic, (obs, action) -> ``[B, output_dim]``."""

    def __init__(self, obs_dim, action_dim, hidden_sizes, activation="relu", layer_norm=False,
                 output_dim=1):
        super().__init__(obs_dim, action_dim, hidden_sizes, 1, activation, layer_norm, output_dim)

    def forward(self, obs, action):
        return super().forward(obs, action)[0]


class DiscreteQNet(nn.Module):
    """obs -> Q-values per action ``[B, nr_actions]``, or with
    ``output_dim_per_action`` > 1 a distributional head ``[B, nr_actions,
    output_dim_per_action]`` (C51 atoms, HL-Gauss bins).  flax's default
    (lecun) init, f32, LayerNorm after every Dense with ``layer_norm_all``
    (PQN).  With ``image_shape`` the trunk is ``NatureCNN`` (no LayerNorm),
    the JAX package's branch for ``[..., H, W, C]`` inputs; a flat net
    refuses image inputs."""

    def __init__(self, obs_dim, nr_actions, hidden_sizes, activation="relu", output_dim_per_action=1,
                 layer_norm_all=False, image_shape=None):
        super().__init__()
        self.nr_actions = nr_actions
        self.output_dim_per_action = output_dim_per_action
        self.vision = image_shape is not None
        self.trunk, width = make_trunk(obs_dim, hidden_sizes, activation, image_shape=image_shape,
                                       orthogonal_init=False, layer_norm_all=layer_norm_all)
        self.head = _lecun_linear(width, nr_actions * output_dim_per_action)

    def forward(self, x):
        if x.ndim >= 4 and not self.vision:
            raise ValueError(f"a net built for flat observations got images of shape {tuple(x.shape)}")
        out = self.head(self.trunk(x))
        if self.output_dim_per_action > 1:
            return out.reshape(out.shape[:-1] + (self.nr_actions, self.output_dim_per_action))
        return out
