"""Parallel seeds: one training program whose every launch carries all S
seeds (the port's counterpart of the JAX package's ``_train_parallel_seeds``,
which vmaps the whole program over a seed axis).

With ``algorithm.nr_parallel_seeds = S > 1``:

- seed ``s`` is the one-seed run whose ``environment.seed`` is
  ``seed_for(seed, s)``: its nets are initialized, its env reset and every
  draw of its run taken as that run takes them, from generators of its own
  (``ParallelSeeds.generators`` on the device, ``host_generators`` for the
  eval and test resets).  The two runs agree up to the rounding of batched
  against unbatched products;
- a net is *seed-stacked*: the S copies are initialized one by one and
  each parameter is replaced by the ``[S, ...]`` stack of theirs
  (``stack_modules``), so one optimizer over ``module.parameters()``
  steps every seed (Adam and Polyak averaging are elementwise, the step
  count is shared) and ``ParallelSeeds.map`` runs a one-seed function of
  the nets over ``[S, B, ...]`` inputs as ONE batched call
  (``torch.func.vmap`` of ``functional_call``: each seed sees its own slice
  of every parameter).  Reductions inside the mapped function (loss means,
  advantage normalization, medians, batch statistics) are per seed; the
  summed per-seed losses give each seed its own gradient;
- running statistics (CrossQ's BatchRenorm, FlashSAC's BatchNorm) are
  seed-stacked buffers beside the parameters: a train-mode forward under
  the map takes each seed's batch statistics over its own rows, the map
  hands them out, and ``commit_batch_stats`` applies them outside it;
- the kernels have no batching rule: they run between mapped functions,
  on the seeds' rows folded into one batch (``merge`` / ``split``), and a
  draw inside an update is taken outside the map from each seed's
  generator (``draw``) and passed in;
- the env holds all ``S * N`` envs, seed-major (rows ``s * N .. (s+1) * N``
  are seed s's), and draws each seed's rows from that seed's generator
  (``environments/env.py::draw``), so kernel B2 steps them in one launch;
  B1 and B3 likewise see the seeds folded into their batch;
- ``eval_history`` maps each eval metric to ``[S, nr_eval_save_iterations]``
  values; after ``train()`` the model keeps seed 0's nets, optimizer state
  and generators (``finish``), so save, load and test mode work as
  after a one-seed run.

Logging, ``runner.save_model`` and ``runner.chunked_train`` refuse S > 1
(``check_config``), with the JAX package's wording.
"""

import torch
from torch import nn
from torch.func import functional_call, vmap

from rlx_tpu_torch.algorithms.train_state import TrainState
from rlx_tpu_torch.models.layers import running_buffers

# seed_for(seed, s) = seed + SEED_STRIDE * s: seed 0 keeps the run's seed,
# and the seeds of one run stay apart from the runs of nearby seeds
SEED_STRIDE = 104_729

# the ROADMAP item that holds what S > 1 does not run yet
QUEUED_ITEM = "ROADMAP Queue A item 19e"


def seed_for(seed, s):
    """The seed of seed ``s`` of a run with ``environment.seed = seed``:
    ``seed`` itself for s = 0 and a distinct seed for every s."""
    return int(seed) + SEED_STRIDE * int(s)


def nr_parallel_seeds(config):
    """``algorithm.nr_parallel_seeds`` (1 where the config has no such key)."""
    return int(config.algorithm.get("nr_parallel_seeds", 1))


def check_config(config):
    """The JAX package's guards: S > 1 needs logging, saving and the
    chunked program off."""
    if nr_parallel_seeds(config) <= 1:
        return
    if config.algorithm.get("logging_active", False) or config.runner.save_model:
        raise ValueError(
            "nr_parallel_seeds > 1 requires algorithm.logging_active=False "
            "and runner.save_model=False (callbacks cannot run under vmap); "
            "results are recorded per-seed in eval_history"
        )
    if config.runner.chunked_train:
        raise ValueError(
            "nr_parallel_seeds > 1 runs one fused vmapped program and cannot "
            "honor runner.chunked_train (bounded per-call device executions); "
            "run seeds separately or disable chunked_train"
        )


def refuse(config, what):
    """Raise ``NotImplementedError`` when ``what`` is asked to run S > 1."""
    if nr_parallel_seeds(config) > 1:
        raise NotImplementedError(f"{what} does not run nr_parallel_seeds > 1 yet ({QUEUED_ITEM})")


def _owner(module, name):
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    return module, leaf


def stack_modules(modules):
    """``modules[0]`` with every parameter replaced by the ``[S, ...]`` stack
    of the S modules' parameters (same ``requires_grad``), and every buffer
    of running statistics (``models/layers.running_buffers``: BatchRenorm's,
    FlashSAC's BatchNorm's) by the stack of theirs, so each seed keeps its
    own.  The other buffers stay ``modules[0]``'s: they are equal across
    seeds (observation indices, bins)."""
    first = modules[0]
    for name, param in list(first.named_parameters()):
        owner, leaf = _owner(first, name)
        stacked = torch.stack([dict(m.named_parameters())[name].detach() for m in modules])
        owner._parameters[leaf] = nn.Parameter(stacked, requires_grad=param.requires_grad)
    for name in running_buffers(first):
        owner, leaf = _owner(first, name)
        owner._buffers[leaf] = torch.stack([running_buffers(m)[name] for m in modules])
    return first


def unstack_module(module, s=0):
    """Replace every ``[S, ...]`` parameter of ``module`` by its slice ``s``,
    in place, and every running-statistics buffer likewise; returns
    ``[(stacked, new)]`` parameter pairs."""
    pairs = []
    for name, param in list(module.named_parameters()):
        owner, leaf = _owner(module, name)
        new = nn.Parameter(param.detach()[s].clone(), requires_grad=param.requires_grad)
        owner._parameters[leaf] = new
        pairs.append((param, new))
    for name, buffer in running_buffers(module).items():
        owner, leaf = _owner(module, name)
        owner._buffers[leaf] = buffer[s].clone()
    return pairs


def unstack_optimizer(optimizer, pairs, s=0):
    """Point ``optimizer`` at the unstacked parameters of ``pairs`` (from
    ``unstack_module``), its per-parameter state cut to slice ``s``."""
    swap = {id(old): new for old, new in pairs}
    for group in optimizer.param_groups:
        group["params"] = [swap.get(id(p), p) for p in group["params"]]
    state = {}
    for param, value in optimizer.state.items():
        new = swap.get(id(param), param)
        if new is not param:
            value = {k: v[s].clone() if torch.is_tensor(v) and v.ndim > 0 else v for k, v in value.items()}
        state[new] = value
    optimizer.state.clear()
    optimizer.state.update(state)


def keep_first_seed(*states):
    """Cut each ``(module, optimizer or None)`` of a parallel-seed run to
    seed 0, in place (what the JAX package keeps after its vmapped run)."""
    for module, optimizer in states:
        pairs = unstack_module(module)
        if optimizer is not None:
            unstack_optimizer(optimizer, pairs)


def finish(model, *states):
    """End a parallel-seed ``train()``: cut each ``(module, optimizer or
    None)`` of ``model`` to seed 0 and hand back seed 0's generators, so the
    model is seed 0's one-seed model."""
    keep_first_seed(*states)
    model.generator = model.parallel.generators[0]
    model.host_generator = model.parallel.host_generators[0]
    model.parallel = None


def stack_train_states(states):
    """One ``TrainState`` of seed-stacked nets from S per-seed ones (the
    module, the target, and an optimizer of the same type and settings
    over the stacked parameters)."""
    first = states[0]
    module = stack_modules([st.module for st in states])
    stacked = TrainState.__new__(TrainState)
    stacked.module = module
    (group,) = first.optimizer.param_groups
    settings = {k: v for k, v in group.items() if k != "params"}
    stacked.optimizer = type(first.optimizer)([{**settings, "params": list(module.parameters())}])
    stacked.target = None if first.target is None else stack_modules([st.target for st in states])
    return stacked


def stack_states(states):
    """Seed-stack the per-seed values of one state: ``TrainState``s as
    ``stack_train_states``, dicts of tensors tensor by tensor."""
    if isinstance(states[0], TrainState):
        return stack_train_states(states)
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def first_seed_state(state):
    """Seed 0 of a seed-stacked state, in place for a ``TrainState``."""
    if isinstance(state, TrainState):
        keep_first_seed((state.module, state.optimizer))
        if state.target is not None:
            unstack_module(state.target)
        return state
    return {k: v[0].clone() for k, v in state.items()}


@torch.no_grad()
def masked_adam_step(optimizer, active, learning_rates):
    """One Adam step (torch's update, eps and betas from ``optimizer``) of
    seed-stacked parameters, taken only by the seeds where ``active``
    (``[S]`` bool), each with its own step count (``state["step"]``, ``[S]``
    on the CPU) and learning rate (``learning_rates``, S floats).  A seed
    that does not step keeps its parameters, moments and count, as the JAX
    package's per-seed select of the whole train state (ESPO's early stop)."""
    steps_taken = active.cpu().to(torch.float32)
    for group in optimizer.param_groups:
        beta1, beta2 = group["betas"]
        eps = group["eps"]
        for p in group["params"]:
            state = optimizer.state[p]
            if not state:
                state["step"] = torch.zeros(p.shape[0])
                state["exp_avg"] = torch.zeros_like(p)
                state["exp_avg_sq"] = torch.zeros_like(p)
            step = state["step"] + steps_taken
            # a seed that has not stepped yet divides by nothing: count 1
            count = torch.clamp(step, min=1.0).to(torch.float64)
            step_size = torch.as_tensor(learning_rates, dtype=torch.float64) / (1.0 - beta1 ** count)
            bias_correction2_sqrt = torch.sqrt(1.0 - beta2 ** count)
            shape = (-1,) + (1,) * (p.ndim - 1)
            on = active.reshape(shape)
            grad = p.grad
            exp_avg = state["exp_avg"].lerp(grad, 1.0 - beta1)
            exp_avg_sq = state["exp_avg_sq"].mul(beta2).addcmul_(grad, grad, value=1.0 - beta2)
            denom = (exp_avg_sq.sqrt() / bias_correction2_sqrt.to(p).reshape(shape)).add_(eps)
            new = p - step_size.to(p).reshape(shape) * exp_avg / denom
            p.copy_(torch.where(on, new, p))
            state["exp_avg"] = torch.where(on, exp_avg, state["exp_avg"])
            state["exp_avg_sq"] = torch.where(on, exp_avg_sq, state["exp_avg_sq"])
            state["step"] = step


def _stack(trees):
    """One tree of ``[S, ...]`` tensors from S trees of the same structure."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_stack(list(leaves)) for leaves in zip(*trees))
    return torch.stack(trees)


class NoGenerator:
    """Stands for a one-seed generator while a parallel-seed run trains: a
    draw from it fails (torch takes no such generator) instead of sharing
    one stream across the seeds."""

    def __repr__(self):
        return "NoGenerator()"


class _Holder(nn.Module):
    """The nets a mapped function reads, as children of one module, so one
    ``functional_call`` swaps in each seed's slice of all of them."""

    def __init__(self, modules):
        super().__init__()
        for name, module in modules.items():
            self.add_module(name, module)

    def forward(self, fn, *xs):
        return fn(*xs)


class ParallelSeeds:
    """The seed axis of one run: its seeds, their generators, seed-stacked
    nets and the batched map over them."""

    def __init__(self, seed, nr_seeds, device):
        self.nr_seeds = int(nr_seeds)
        self.device = torch.device(device)
        self.seeds = [seed_for(seed, s) for s in range(self.nr_seeds)]
        self.generators = [torch.Generator(device=self.device).manual_seed(x) for x in self.seeds]
        self.host_generators = [torch.Generator().manual_seed(x) for x in self.seeds]

    def init(self, build):
        """``[build() for each seed]``, each call under ``torch.manual_seed``
        of its seed, as the one-seed run initializes its nets; stack the
        modules of the results with ``stack_modules``."""
        built = []
        for seed in self.seeds:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                built.append(build())
        return built

    def map(self, fn, modules, *xs):
        """``fn(*xs_s)`` for every seed s in one batched call, where ``xs``
        are tensors (or dicts / tuples of them) with a leading seed axis and
        ``fn`` reads the nets ``modules`` ({name: seed-stacked module}) as
        one seed's nets, their running statistics included.  Returns
        ``fn``'s outputs with a leading seed axis.

        A train-mode forward of a norm layer leaves its batch statistics
        pending on the layer; under the map they are one seed's, over its
        own rows.  They leave the map as outputs and are set on the layer
        stacked ``[S, ...]``, so ``commit_batch_stats`` applies each seed's
        to its own running statistics, outside the map."""
        holder = _Holder(modules)
        tensors = {**dict(holder.named_parameters()), **running_buffers(holder)}
        norms = [m for m in holder.modules() if hasattr(m, "pending")]
        kept = [m.pending for m in norms]
        for m in norms:
            m.pending = None

        def one(p, args):
            out = functional_call(holder, p, (fn,) + tuple(args))
            pending = {}
            for i, m in enumerate(norms):
                if m.pending is not None:
                    pending[i], m.pending = m.pending, None
            return out, pending

        out, pending = vmap(one)(tensors, xs)
        for i, m in enumerate(norms):
            m.pending = pending.get(i, kept[i])
        return out

    def draw(self, sample):
        """``[S, ...]``: ``sample(generator)`` for each seed's generator, so
        seed s takes the draw its one-seed run takes.  ``sample`` may return
        dicts, tuples or lists of tensors, stacked leaf by leaf."""
        return _stack([sample(g) for g in self.generators])

    def host_seeds(self):
        """One reset seed per seed from its host generator (the one-seed
        run's ``torch.randint(2**31 - 1, (), generator=host_generator)``)."""
        return [int(torch.randint(2**31 - 1, (), generator=g)) for g in self.host_generators]

    def split(self, x):
        """``[S * N, ...]`` seed-major rows -> ``[S, N, ...]``."""
        return x.reshape((self.nr_seeds, -1) + tuple(x.shape[1:]))

    @staticmethod
    def merge(x):
        """``[S, N, ...]`` -> ``[S * N, ...]``."""
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def split_time(self, x):
        """``[T, S * N, ...]`` (a rollout) -> ``[S, T * N, ...]``, each seed's
        rows step-major as its one-seed run flattens them."""
        T = x.shape[0]
        x = x.reshape((T, self.nr_seeds, -1) + tuple(x.shape[2:])).transpose(0, 1)
        return x.reshape((self.nr_seeds, -1) + tuple(x.shape[3:]))

    def merge_time(self, x, T):
        """Inverse of ``split_time``: ``[S, T * N, ...]`` -> ``[T, S * N, ...]``."""
        x = x.reshape((self.nr_seeds, T, -1) + tuple(x.shape[2:])).transpose(0, 1)
        return x.reshape((T, -1) + tuple(x.shape[3:]))

    def take(self, x, idx):
        """Rows ``idx[s]`` of each seed: ``x`` ``[S, N, ...]``, ``idx``
        ``[S, M]`` -> ``[S, M, ...]``."""
        return x[torch.arange(self.nr_seeds, device=x.device)[:, None], idx]

    def rows(self, idx, nr_rows):
        """Seed-local row indices ``[S, M]`` into flat seed-major ones
        ``[S * M]`` of ``S * nr_rows`` rows."""
        offsets = torch.arange(self.nr_seeds, device=idx.device)[:, None] * nr_rows
        return (idx + offsets).reshape(-1)

