"""Diagonal-Gaussian helpers for continuous policies (the same log-prob and
entropy formulations as the JAX package)."""

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)


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
