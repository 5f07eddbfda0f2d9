"""Differentiable trust-region projections for diagonal Gaussian policies
(the JAX package's ``ppo_dtrl/tpu/trust_region.py``):

- the mean projection rescales the mean's step onto the Mahalanobis ball
  of the old policy when the KL's mean part exceeds ``mean_bound``;
- the covariance projection interpolates the precisions,
  ``(eta / old_var + 1 / var) / (eta + 1)``, with the dual ``eta`` per
  sample from 15 damped, clipped Newton steps on ``log_eta``.  Each step
  needs the derivative of the covariance KL in ``log_eta``; it is written
  in closed form, so autograd differentiates the policy's gradient through
  all 15 unrolled steps, that derivative included, as ``jax.grad`` inside
  the JAX package's scan does;
- the entropy projection shifts every log-std up uniformly to a minimum
  entropy.

Every clip uses ``clip``, whose gradient at a bound is half the
incoming one, as ``jnp.clip``'s (``torch.clamp`` passes all of it).
All ops are batched ``[B, A]``.
"""

import math

import torch

LOG_2PI_E = math.log(2.0 * math.pi * math.e)


def clip(x, low, high):
    """``jnp.clip``: ``minimum(maximum(x, low), high)``, whose gradient at a
    tie is split evenly, as JAX's."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, low)), torch.full_like(x, high))


def gaussian_kl_parts(mean, std, old_mean, old_std):
    """KL(old || new) of diagonal Gaussians, split into its mean part and its
    covariance part ``[B]``."""
    mean_part = 0.5 * (((mean - old_mean) / old_std) ** 2).sum(-1)
    cov_part = 0.5 * (2.0 * (torch.log(std) - torch.log(old_std)) + (old_std / std) ** 2 - 1.0).sum(-1)
    return mean_part, cov_part


def mean_projection(mean, old_mean, old_std, mean_bound):
    """(mean scaled back onto the Mahalanobis ball where ``maha / 2 >
    mean_bound``, maha)."""
    maha = (((mean - old_mean) / old_std) ** 2).sum(-1)
    scale = torch.sqrt(mean_bound / torch.maximum(maha, torch.full_like(maha, 1e-12)))
    needs = maha > 2.0 * mean_bound
    step = torch.minimum(scale * math.sqrt(2.0), torch.ones_like(scale))
    proj = old_mean + (mean - old_mean) * step[..., None]
    return torch.where(needs[..., None], proj, mean), maha


def _projected_precision(log_eta, std, old_std):
    eta = torch.exp(log_eta)[..., None]
    return (eta / old_std ** 2 + 1.0 / std ** 2) / (eta + 1.0)


def _cov_kl_and_derivative(log_eta, std, old_std, cov_bound):
    """(cov-KL(old || projected(eta)) - cov_bound, its derivative in
    ``log_eta``) per sample ``[B]``."""
    eta = torch.exp(log_eta)[..., None]
    old_var, inv_var = old_std ** 2, 1.0 / std ** 2
    prec_p = (eta / old_var + inv_var) / (eta + 1.0)
    var_p = 1.0 / prec_p
    value = 0.5 * (torch.log(var_p / old_var) + old_var / var_p - 1.0).sum(-1) - cov_bound
    # d/d prec_p of 0.5 (-log prec_p + old_var prec_p), d prec_p / d eta, d eta / d log_eta
    d_prec = 0.5 * (old_var - var_p)
    d_eta = (1.0 / old_var - inv_var) / (eta + 1.0) ** 2
    derivative = (d_prec * d_eta).sum(-1) * eta[..., 0]
    return value, derivative


def cov_projection(std, old_std, cov_bound, nr_newton_steps=15):
    """(projected std ``[B, A]``, eta ``[B]``): the stds whose covariance part
    of KL(old || new) exceeds ``cov_bound`` are projected, the others kept
    (with eta 0)."""
    log_eta = torch.zeros(std.shape[:-1], dtype=std.dtype, device=std.device)
    for _ in range(nr_newton_steps):
        value, grad = _cov_kl_and_derivative(log_eta, std, old_std, cov_bound)
        safe = torch.where(torch.abs(grad) > 1e-10, grad, torch.sign(grad) * 1e-10 + 1e-12)
        log_eta = clip(log_eta - clip(value / safe, -2.0, 2.0), -10.0, 12.0)
    proj_std = torch.sqrt(1.0 / _projected_precision(log_eta, std, old_std))
    _, cov_part = gaussian_kl_parts(torch.zeros_like(std), std, torch.zeros_like(std), old_std)
    needs = cov_part > cov_bound
    return torch.where(needs[..., None], proj_std, std), torch.where(needs, torch.exp(log_eta), 0.0)


def kl_projection(mean, std, old_mean, old_std, mean_bound, cov_bound):
    """The per-sample trust-region projection: the projected ``mean`` and
    ``std``, ``eta_cov``, and the KL parts before (``kl_mean_part``,
    ``kl_cov_part``) and after (``post_kl_mean_part``, ``post_kl_cov_part``)."""
    kl_mean_part, kl_cov_part = gaussian_kl_parts(mean, std, old_mean, old_std)
    proj_mean, _ = mean_projection(mean, old_mean, old_std, mean_bound)
    proj_std, eta_cov = cov_projection(std, old_std, cov_bound)
    post_mean_part, post_cov_part = gaussian_kl_parts(proj_mean, proj_std, old_mean, old_std)
    return {
        "mean": proj_mean,
        "std": proj_std,
        "eta_cov": eta_cov,
        "kl_mean_part": kl_mean_part,
        "kl_cov_part": kl_cov_part,
        "post_kl_mean_part": post_mean_part,
        "post_kl_cov_part": post_cov_part,
    }


def entropy_projection(log_std, min_entropy):
    """Shift every log-std up uniformly when the entropy is below ``min_entropy``."""
    dim = log_std.shape[-1]
    entropy = 0.5 * dim * LOG_2PI_E + log_std.sum(-1)
    shift = torch.maximum(min_entropy - entropy, torch.zeros_like(entropy)) / dim
    return log_std + shift[..., None]
