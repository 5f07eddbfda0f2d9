"""Diagonal-Gaussian and tanh-Gaussian helpers for continuous policies and
categorical helpers for discrete ones (the same log-prob and entropy
formulations as the JAX package)."""

import math

import torch
import torch.nn.functional as F

LOG_2PI = math.log(2.0 * math.pi)
LOG_2 = math.log(2.0)


def gaussian_sample(mean, logstd, generator=None, noise=None):
    """``mean + std * noise``; ``noise`` is drawn from ``generator`` unless given."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    return mean + torch.exp(logstd) * noise


def gaussian_log_prob(mean, logstd, action):
    """Sum over action dims."""
    std = torch.exp(logstd)
    lp = -0.5 * ((action - mean) / std) ** 2 - 0.5 * LOG_2PI - logstd
    return lp.sum(-1)


def gaussian_entropy(logstd):
    """Per-dim entropy summed over dims (state-independent logstd)."""
    return (logstd + 0.5 * math.log(2.0 * math.pi * math.e)).sum(-1)


def tanh_gaussian_sample_and_log_prob(mean, logstd, generator=None, noise=None):
    """SAC's reparameterized sample ``tanh(mean + std * noise)`` and its log
    probability summed over action dims, with the change of variables in the
    stable form ``log(1 - tanh(x)^2) = 2 (log 2 - x - softplus(-2x))``: the
    direct form loses all precision once |x| passes ~9.  ``noise`` is drawn
    from ``generator`` unless given."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    std = torch.exp(logstd)
    gaussian = mean + std * noise
    action = torch.tanh(gaussian)
    log_prob = -0.5 * ((gaussian - mean) / std) ** 2 - 0.5 * LOG_2PI - logstd
    log_prob = log_prob - 2.0 * (LOG_2 - gaussian - F.softplus(-2.0 * gaussian))
    return action, log_prob.sum(-1)


def tanh_gaussian_mode(mean):
    return torch.tanh(mean)


def categorical_sample(logits, generator=None, noise=None):
    """One action per row of ``logits`` [..., n] by the Gumbel-max trick, as
    ``jax.random.categorical`` samples: ``argmax(logits + noise)`` with
    ``noise`` standard Gumbel, drawn from ``generator`` unless given.
    Returns int32 actions of shape ``logits.shape[:-1]``."""
    if noise is None:
        uniform = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=logits.dtype)
        noise = -torch.log(-torch.log(uniform.clamp_min(torch.finfo(logits.dtype).tiny)))
    return torch.argmax(logits + noise, dim=-1).to(torch.int32)


def categorical_log_prob(logits, action):
    log_p = F.log_softmax(logits, dim=-1)
    return torch.gather(log_p, -1, action.long()[..., None]).squeeze(-1)


def categorical_entropy(logits):
    log_p = F.log_softmax(logits, dim=-1)
    return -(torch.exp(log_p) * log_p).sum(-1)
