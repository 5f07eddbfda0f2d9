"""Training state and optimizer helpers shared by the algorithms: a network
with its target copy and its optimizer (the JAX package's ``RLTrainState``
idea: a train state with target parameters), and the global-norm gradient
helpers the JAX package takes from optax."""

import copy

import torch


def global_norm(tensors):
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def clip_by_global_norm_(grads, max_norm):
    """In place: ``g / norm * max_norm`` where ``norm >= max_norm`` (as
    ``optax.clip_by_global_norm``); returns the unclipped norm."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class TrainState:
    def __init__(self, module, optimizer):
        self.module = module
        self.optimizer = optimizer
        self.target = copy.deepcopy(module).requires_grad_(False)

    @torch.no_grad()
    def polyak_update(self, tau):
        """``target = tau * params + (1 - tau) * target``
        (``optax.incremental_update``)."""
        targets = list(self.target.parameters())
        torch._foreach_mul_(targets, 1.0 - tau)
        torch._foreach_add_(targets, torch._foreach_mul(list(self.module.parameters()), tau))
