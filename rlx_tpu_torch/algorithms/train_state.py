"""Training state and optimizer helpers shared by the algorithms: a network
with its optimizer and, by default, its target copy (the JAX package's
``RLTrainState``; with ``target=False`` flax's plain ``TrainState``), and
the global-norm gradient helpers the JAX package takes from optax."""

import copy

import torch


def global_norm(tensors):
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    in float32 or the tensors' wider type."""
    return torch.sqrt(sum(torch.sum(t.to(torch.promote_types(t.dtype, torch.float32)) ** 2) for t in tensors))


def per_seed_global_norm(grads):
    """``[S]``: the global norm of each seed's slice of seed-stacked
    ``[S, ...]`` tensors (``parallel_seeds.py``)."""
    return torch.sqrt(sum(
        torch.sum(t.to(torch.promote_types(t.dtype, torch.float32)).reshape(t.shape[0], -1) ** 2, dim=1)
        for t in grads))


def clip_by_global_norm_(grads, max_norm, per_seed=False):
    """In place: ``g / norm * max_norm`` where ``norm >= max_norm`` (as
    ``optax.clip_by_global_norm``); returns the unclipped norm.  With
    ``per_seed`` the grads are seed-stacked ``[S, ...]`` and each seed is
    clipped by its own norm (``[S]``), as the JAX package's vmapped clip."""
    if not per_seed:
        norm = global_norm(grads)
        keep = norm < max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * max_norm))
        return norm
    norm = per_seed_global_norm(grads)
    for g in grads:
        n = norm.reshape((-1,) + (1,) * (g.ndim - 1))
        g.copy_(torch.where(n < max_norm, g, g / n * max_norm))
    return norm


def module_state_dict(module, optimizer, target=None):
    """A network's full state, named as flax's ``TrainState`` fields:
    ``params``, ``opt_state`` and, with a target, ``target_params``."""
    out = {"params": module.state_dict(), "opt_state": optimizer.state_dict()}
    if target is not None:
        out["target_params"] = target.state_dict()
    return out


def load_module_state_dict(state, module, optimizer, target=None):
    """Inverse of ``module_state_dict``.  The optimizer's state is loaded
    after the parameters, which already sit on their device, so its moments
    land there too."""
    module.load_state_dict(state["params"])
    if target is not None:
        target.load_state_dict(state["target_params"])
    optimizer.load_state_dict(state["opt_state"])


class TrainState:
    def __init__(self, module, optimizer, target=True):
        self.module = module
        self.optimizer = optimizer
        self.target = copy.deepcopy(module).requires_grad_(False) if target else None

    def apply_gradients(self, grads, learning_rate=None):
        """One optimizer step on ``grads`` (one per parameter, in
        ``module.parameters()`` order), at ``learning_rate`` when given
        (flax's ``TrainState.apply_gradients``)."""
        for p, g in zip(self.module.parameters(), grads):
            p.grad = g
        if learning_rate is not None:
            self.optimizer.param_groups[0]["lr"] = learning_rate
        self.optimizer.step()

    def step_count(self):
        """Optimizer steps taken (optax's ``count``): 0 before the first."""
        state = self.optimizer.state.get(next(self.module.parameters()))
        return int(state["step"]) if state else 0

    @torch.no_grad()
    def polyak_update(self, tau):
        """``target = tau * params + (1 - tau) * target``
        (``optax.incremental_update``)."""
        targets = list(self.target.parameters())
        torch._foreach_mul_(targets, 1.0 - tau)
        torch._foreach_add_(targets, torch._foreach_mul(list(self.module.parameters()), tau))

    @torch.no_grad()
    def hard_update(self):
        """``target = params``, exactly (the DQN family's target copy)."""
        for target, param in zip(self.target.parameters(), self.module.parameters()):
            target.copy_(param)

    def state_dict(self):
        return module_state_dict(self.module, self.optimizer, self.target)

    def load_state_dict(self, state):
        load_module_state_dict(state, self.module, self.optimizer, self.target)
