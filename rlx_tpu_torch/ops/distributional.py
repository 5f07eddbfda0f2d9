"""Distributional value-learning ops: the categorical (C51) projection of a
shifted support onto a fixed atom grid (FastTD3's categorical critics).

- ``categorical_projection``: the scatter formulation (each mass split
  between its two neighbouring atoms), kept as the oracle;
- ``categorical_projection_dense``: the function of the TPU kernel, whose
  plain version ``categorical_projection_reference`` is its dense
  hat-kernel formulation.  A CUDA tensor goes through the hand-written
  kernel (``rlx_tpu_torch.ops.projection_cuda``), which computes the same
  hat weights but scatters them, a warp per row, onto the two atoms each
  mass touches; a CPU tensor goes through the plain version.
"""

import torch


def _atom_positions(target_z, v_min, v_max, nr_atoms):
    """Fractional atom index of each clipped position: a true division by
    ``delta_z`` rounded once to the input's type, as the JAX package's
    weak-typed constant is.  ``delta_z`` is a tensor because PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal instead."""
    delta_z = torch.tensor((v_max - v_min) / (nr_atoms - 1), dtype=target_z.dtype,
                           device=target_z.device)
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
