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


@torch.no_grad()
def adam_step_(optimizer, learning_rate, active=None):
    """One Adam step of every parameter of a ``torch.optim.Adam`` or
    ``AdamW`` (its one parameter group) by its gradient, in the optimizer's
    own state, so its ``state_dict()`` stays the checkpoint's format.
    Written in tensor ops with no host read, so a CUDA graph can capture it,
    and run alike eagerly on either device:

    - ``learning_rate`` is a 0-dim tensor on the parameters' device (the
      schedule's rate at the device step count), float64 where it must
      equal a host rate;
    - ``state["step"]`` is a 0-dim float32 tensor on the parameter's device
      (one made on the CPU, by a checkpoint or torch's own step, is moved
      there at the next eager step);
    - torch's arithmetic, in its order, so that on the CPU it is torch's
      ``Adam`` / ``AdamW`` step bit for bit: the group's weight decay first
      (``AdamW``: ``p *= 1 - lr * wd``; ``Adam``: ``g += wd * p``), then
      ``exp_avg.lerp_(g, 1 - b1)``, ``exp_avg_sq * b2 + (1 - b2) g^2``, ``p
      -= lr / (1 - b1^t) * exp_avg / (sqrt(exp_avg_sq) / sqrt(1 - b2^t) +
      eps)``, the product before the division, the bias corrections and
      ``1 - lr * wd`` taken in float64;
    - with ``active`` (a 0-dim bool tensor) the parameters, moments and step
      counts change only where it is true, as the JAX package's select of
      the whole train state (ESPO's early stop, the TD3 family's policy
      delay).
    """
    (group,) = optimizer.param_groups
    if group.get("amsgrad") or group.get("maximize"):
        raise NotImplementedError("adam_step_ takes neither amsgrad nor maximize")
    beta1, beta2 = group["betas"]
    eps = group["eps"]
    weight_decay = group.get("weight_decay", 0.0)
    decoupled = group.get("decoupled_weight_decay", isinstance(optimizer, torch.optim.AdamW))
    params = [p for p in group["params"] if p.grad is not None]
    states = [optimizer.state[p] for p in params]
    for p, state in zip(params, states):
        if not state:
            state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        elif state["step"].device != p.device:
            state["step"] = state["step"].to(p.device, torch.float32)
    steps = [s["step"] for s in states]
    exp_avgs = [s["exp_avg"] for s in states]
    exp_avg_sqs = [s["exp_avg_sq"] for s in states]
    grads = [p.grad for p in params]
    dtype = params[0].dtype
    decayed = params
    if weight_decay and decoupled:
        factor = (1.0 - learning_rate.double() * weight_decay).to(dtype)
        if active is None:
            torch._foreach_mul_(params, factor)
        else:
            decayed = torch._foreach_mul(params, factor)
    elif weight_decay:
        grads = torch._foreach_add(grads, params, alpha=weight_decay)
    # the nets step together: one count serves every parameter
    count = steps[0].double() + 1.0
    step_size = learning_rate.double() / (1.0 - beta1 ** count)
    bias_correction2_sqrt = torch.sqrt(1.0 - beta2 ** count)
    if active is None:
        new_avgs, new_avg_sqs = exp_avgs, exp_avg_sqs
        torch._foreach_lerp_(exp_avgs, grads, 1.0 - beta1)
        torch._foreach_mul_(exp_avg_sqs, beta2)
        torch._foreach_addcmul_(exp_avg_sqs, grads, grads, value=1.0 - beta2)
    else:
        new_avgs = torch._foreach_lerp(exp_avgs, grads, 1.0 - beta1)
        new_avg_sqs = torch._foreach_mul(exp_avg_sqs, beta2)
        torch._foreach_addcmul_(new_avg_sqs, grads, grads, value=1.0 - beta2)
    denominators = torch._foreach_sqrt(new_avg_sqs)
    torch._foreach_div_(denominators, bias_correction2_sqrt.to(dtype))
    torch._foreach_add_(denominators, eps)
    updates = torch._foreach_mul(new_avgs, step_size.to(dtype))
    torch._foreach_div_(updates, denominators)
    if active is None:
        torch._foreach_sub_(params, updates)
        torch._foreach_add_(steps, 1.0)
        return
    new_params = torch._foreach_sub(decayed, updates)
    for olds, news in ((params, new_params), (exp_avgs, new_avgs), (exp_avg_sqs, new_avg_sqs),
                       (steps, [s + 1.0 for s in steps])):
        for old, new in zip(olds, news):
            old.copy_(torch.where(active, new, old))


class DeviceStepSchedule:
    """The optimizer step count on the device and the learning rate read
    from it, for the on-policy families whose Adam steps every net together
    once a minibatch (PPO, the recurrent PPO, PQN): nothing reads the count
    back inside a learning iteration, so a CUDA graph can capture it.

    A subclass sets ``learning_rate``, ``anneal_learning_rate``,
    ``nr_updates``, ``nr_minibatches``, ``nr_epochs`` and
    ``optimizer_names`` (the attributes holding its ``torch.optim.Adam``
    objects) and calls ``init_optimizer_steps`` once its device is known.
    The rate anneals linearly per learning iteration of ``nr_minibatches *
    nr_epochs`` steps, as the JAX packages' optax schedules."""

    optimizer_names = ("policy_optimizer", "critic_optimizer")

    def init_optimizer_steps(self, device):
        self.optimizer_steps = torch.zeros((), dtype=torch.int64, device=device)

    @property
    def nr_optimizer_steps(self):
        """The optimizer steps taken, read from the device count (the
        checkpoint's count, and the schedule's)."""
        return int(self.optimizer_steps)

    @nr_optimizer_steps.setter
    def nr_optimizer_steps(self, count):
        self.optimizer_steps.fill_(int(count))

    def learning_rate_at(self, count):
        """Learning rate for the update that follows ``count`` updates."""
        if not self.anneal_learning_rate:
            return self.learning_rate
        fraction = 1.0 - (count // (self.nr_minibatches * self.nr_epochs)) / max(self.nr_updates, 1)
        return self.learning_rate * fraction

    def learning_rate_tensor(self, count):
        """``learning_rate_at`` of a device count (an int64 0-dim tensor), on
        its device in float64, with the host's arithmetic."""
        if not self.anneal_learning_rate:
            return torch.full((), self.learning_rate, dtype=torch.float64, device=count.device)
        period = self.nr_minibatches * self.nr_epochs
        fraction = 1.0 - torch.div(count, period, rounding_mode="floor").double() / max(self.nr_updates, 1)
        return self.learning_rate * fraction

    def _step_optimizers(self, active=None):
        """One Adam step of every net at the rate of the device step count,
        which it advances; with ``active`` (a 0-dim bool tensor) only where
        it is true.  Returns the rate (float64)."""
        lr = self.learning_rate_tensor(self.optimizer_steps)
        for name in self.optimizer_names:
            adam_step_(getattr(self, name), lr, active)
        self.optimizer_steps += 1 if active is None else active.long()
        return lr


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

    # the dp mesh the gradients are averaged over (``parallel/mesh.py``; the
    # off-policy core sets it)
    mesh = None

    def apply_gradients(self, grads, learning_rate=None, reduced=False, active=None):
        """One optimizer step on ``grads`` (one per parameter, in
        ``module.parameters()`` order) by ``adam_step_`` (flax's
        ``TrainState.apply_gradients``), at ``learning_rate``: a 0-dim
        device tensor (float64) that nothing reads back, a host float
        (written into the optimizer's group as well), or none for the
        group's own rate.  With ``active`` a 0-dim bool tensor the
        parameters and Adam's state change only where it is true; with a
        host bool the step is taken or not.  On a dp mesh the gradients are
        first averaged over dp, in place, unless ``reduced`` says the caller
        did (before a clip)."""
        if active is False:
            return
        if active is True:
            active = None
        if self.mesh is not None and not reduced:
            self.mesh.all_reduce_mean_(list(grads))
        params = list(self.module.parameters())
        for p, g in zip(params, grads):
            p.grad = g
        group = self.optimizer.param_groups[0]
        if learning_rate is None:
            learning_rate = group["lr"]
        if not isinstance(learning_rate, torch.Tensor):
            group["lr"] = learning_rate
            learning_rate = torch.full((), learning_rate, dtype=torch.float64, device=params[0].device)
        adam_step_(self.optimizer, learning_rate, active)

    def step_count(self):
        """Optimizer steps taken (optax's ``count``): 0 before the first.
        Reads the count back to the host."""
        state = self.optimizer.state.get(next(self.module.parameters()))
        return int(state["step"]) if state else 0

    def step_tensor(self):
        """``step_count`` as a 0-dim float32 tensor on the parameters' device,
        read nowhere: Adam's own count once it has stepped."""
        param = next(self.module.parameters())
        state = self.optimizer.state.get(param)
        if not state:
            return torch.zeros((), dtype=torch.float32, device=param.device)
        return state["step"].to(param.device)

    @torch.no_grad()
    def polyak_update(self, tau, active=None):
        """``target = tau * params + (1 - tau) * target``
        (``optax.incremental_update``); with ``active`` only where it is
        true (a 0-dim bool tensor) or when it is (a host bool)."""
        if active is False:
            return
        if active is True:
            active = None
        targets = list(self.target.parameters())
        moved = torch._foreach_mul(list(self.module.parameters()), tau)
        if active is None:
            torch._foreach_mul_(targets, 1.0 - tau)
            torch._foreach_add_(targets, moved)
            return
        new = torch._foreach_mul(targets, 1.0 - tau)
        torch._foreach_add_(new, moved)
        for target, value in zip(targets, new):
            target.copy_(torch.where(active, value, target))

    @torch.no_grad()
    def hard_update(self):
        """``target = params``, exactly (the DQN family's target copy)."""
        for target, param in zip(self.target.parameters(), self.module.parameters()):
            target.copy_(param)

    def state_dict(self):
        return module_state_dict(self.module, self.optimizer, self.target)

    def load_state_dict(self, state):
        load_module_state_dict(state, self.module, self.optimizer, self.target)
