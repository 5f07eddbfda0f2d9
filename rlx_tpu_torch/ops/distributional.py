"""Distributional value-learning ops: the categorical (C51) projection of a
shifted support onto a fixed atom grid (FastTD3's categorical critics and
C51), and the HL-Gauss histogram targets and expectation (DQN-HL-Gauss).

- ``categorical_projection``: the scatter formulation (each mass split
  between its two neighbouring atoms), kept as the oracle;
- ``categorical_projection_dense``: the function of the TPU kernel, whose
  plain version ``categorical_projection_reference`` is its dense
  hat-kernel formulation.  A CUDA tensor goes through the hand-written
  kernel (``rlx_tpu_torch.ops.projection_cuda``), which computes the same
  hat weights but scatters them, a warp per row, onto the two atoms each
  mass touches; a CPU tensor goes through the plain version.
"""

import math

import torch


def _atom_positions(target_z, v_min, v_max, nr_atoms):
    """Fractional atom index of each clipped position: a true division by
    ``delta_z`` rounded once to the input's type, as the JAX package's
    weak-typed constant is.  ``delta_z`` is a tensor because PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal instead; it is
    filled on the device, not copied from the host (a graph can capture
    it)."""
    delta_z = torch.full((), (v_max - v_min) / (nr_atoms - 1), dtype=target_z.dtype, device=target_z.device)
    return (torch.clamp(target_z, v_min, v_max) - v_min) / delta_z


def categorical_projection(target_z, probs, v_min, v_max, nr_atoms):
    """Project mass ``probs`` [..., A] at positions ``target_z`` [..., A]
    onto the uniform atom grid -> [..., nr_atoms] by scatter-adding each
    mass onto its two neighbouring atoms (all of it onto the lower one when
    the position is an atom)."""
    b = _atom_positions(target_z, v_min, v_max, nr_atoms)
    lower = torch.floor(b)
    upper = torch.ceil(b)
    on_atom = (upper == lower).to(probs.dtype)
    lower_weight = probs * (upper - b + on_atom)
    upper_weight = probs * (b - lower)
    in_atoms = target_z.shape[-1]
    flat = lambda x: x.reshape(-1, in_atoms)
    out = torch.zeros(flat(probs).shape[0], nr_atoms, dtype=probs.dtype, device=probs.device)
    out.scatter_add_(1, flat(lower).long(), flat(lower_weight))
    out.scatter_add_(1, flat(upper).long(), flat(upper_weight))
    return out.reshape(target_z.shape[:-1] + (nr_atoms,))


def categorical_projection_dense(target_z, probs, v_min, v_max, nr_atoms):
    """``out[..., i] = sum_j clip(1 - |b_j - i|, 0, 1) * probs[..., j]``,
    with ``b_j`` the fractional atom position of ``target_z[..., j]``;
    the same function as ``categorical_projection``."""
    if target_z.is_cuda:
        from rlx_tpu_torch.ops.projection_cuda import categorical_projection_cuda

        return categorical_projection_cuda(target_z, probs, v_min, v_max, nr_atoms)
    return categorical_projection_reference(target_z, probs, v_min, v_max, nr_atoms)


def categorical_projection_reference(target_z, probs, v_min, v_max, nr_atoms):
    """The dense hat-kernel contraction in plain PyTorch (the kernel's plain
    version): materializes the ``[..., nr_atoms, A_in]`` weights."""
    b = _atom_positions(target_z, v_min, v_max, nr_atoms)                 # [..., A_in]
    atoms = torch.arange(nr_atoms, dtype=probs.dtype, device=probs.device)  # [A_out]
    w = torch.clamp(1.0 - torch.abs(b[..., None, :] - atoms[:, None]), 0.0, 1.0)
    return torch.einsum("...ij,...j->...i", w, probs)


def normal_cdf(x):
    """The standard normal CDF in the form of ``jax.scipy.special.ndtr``
    (and scipy's): ``1 + erf`` near 0, ``erfc`` in the tails.  Its lower
    tail keeps its relative precision, where ``torch.special.ndtr``'s
    ``1 + erf`` form cancels (f32: 5 % off at -5.1, 0 below -5.3), and the
    HL-Gauss mass of a value outside the support lives in that tail."""
    w = x * (0.5 * math.sqrt(2.0))
    z = torch.abs(w)
    tail = torch.where(w > 0, 2.0 - torch.special.erfc(z), torch.special.erfc(z))
    return 0.5 * torch.where(z < 0.5 * math.sqrt(2.0), 1.0 + torch.special.erf(w), tail)


def hl_gauss_targets(values, v_min, v_max, nr_bins, sigma_ratio=0.75):
    """Histogram-loss-Gaussian targets for scalars ``values`` [...] ->
    [..., nr_bins]: the mass of a Gaussian centred at each value with
    ``sigma = sigma_ratio * bin_width`` in each of ``nr_bins`` equal bins of
    [v_min, v_max], normalised by the mass inside the support (at least
    1e-8)."""
    bin_width = (v_max - v_min) / nr_bins
    # made on the device, not copied from the host (a graph can capture it),
    # and divided by as a tensor: CUDA divides by a host scalar as a product
    # with its reciprocal
    sigma = torch.full((), sigma_ratio * bin_width, dtype=values.dtype, device=values.device)
    edges = v_min + bin_width * torch.arange(nr_bins + 1, dtype=values.dtype, device=values.device)
    cdf = normal_cdf((edges[None, :] - values.reshape(-1, 1)) / sigma)
    mass = cdf[:, -1] - cdf[:, 0]
    probs = (cdf[:, 1:] - cdf[:, :-1]) / torch.clamp(mass[:, None], min=1e-8)
    return probs.reshape(values.shape + (nr_bins,))


def hl_gauss_expectation(logits, v_min, v_max):
    """Expected value of a histogram head's softmax over the bin centres
    ``v_min + bin_width * (i + 0.5)``."""
    nr_bins = logits.shape[-1]
    bin_width = (v_max - v_min) / nr_bins
    centers = v_min + bin_width * (torch.arange(nr_bins, dtype=logits.dtype, device=logits.device) + 0.5)
    return (torch.softmax(logits, dim=-1) * centers).sum(-1)
