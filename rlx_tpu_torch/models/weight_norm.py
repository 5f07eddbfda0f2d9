"""Weight-norm parameterization as a projection after each optimizer step
(the JAX package's ``models/weight_norm.py``, XQC's).

Each hidden Dense layer's input weights per output unit, the bias taken as
one more input, are scaled to unit L2 norm; each predictor head's weights
per output unit are, with ``normalize_last_layer``, scaled to unit norm
with the bias left as it is.  flax stores a kernel ``[in, out]`` and
normalizes over axis -2; the port's weights are ``[..., out, in]``, so the
norm is over the last axis.  The JAX package finds the layers by flax's
auto-names (``Dense_*`` hidden, ``mean`` / ``log_std`` / ``value``
predictors); the port's networks name them in lists instead.
"""

import torch


@torch.no_grad()
def _norm_dense(layer, norm_bias):
    weight, bias = layer.weight, getattr(layer, "bias", None)
    if norm_bias and bias is not None:
        weights = torch.cat([weight, bias.unsqueeze(-1)], dim=-1)
    else:
        weights = weight
    norm = torch.linalg.vector_norm(weights, dim=-1, keepdim=True)
    weight.div_(norm)
    if norm_bias and bias is not None:
        bias.div_(norm.squeeze(-1))


def weight_norm_(hidden_layers, predictor_layers=(), normalize_last_layer=True):
    """In place: every layer of ``hidden_layers`` normalized with its bias,
    and every layer of ``predictor_layers`` without it when
    ``normalize_last_layer``."""
    for layer in hidden_layers:
        _norm_dense(layer, norm_bias=True)
    if normalize_last_layer:
        for layer in predictor_layers:
            _norm_dense(layer, norm_bias=False)
