"""Tensor parallelism over the mesh's tp group: the port's counterpart of
``rlx_tpu/parallel/partition.py``.

The rules are the JAX package's, over the port's parameter names: a spec
says how a Dense kernel is split, in flax's ``[in, out]`` layout, so
``COLUMN`` (``P(None, "tp")``) splits the outputs (dim 0 of a torch
``weight``) and ``ROW`` (``P("tp", None)``) the inputs (dim 1).
``tp_specs_for_tree`` alternates them Megatron style (column for the k-th
Dense of even k, row for odd k, k counted within each module as flax
names them: ``trunk.layers.<k>``, and the head as its own ``Dense_0``),
falling back to the other orientation, then to replication, when a width
does not divide.

In torch the specs become real column- and row-parallel layers
(``shard_module_``): each tp rank keeps its slice of every split weight
(a column layer's bias and the LayerNorm after it are split with its
outputs), and the net's forward runs ``tp_forward``:

- a column layer takes the whole input and gives this rank's outputs;
  its input's gradient is all-reduced over tp (every rank holds part of it);
- a row layer takes this rank's inputs and gives a partial sum, made whole
  by ONE all_reduce over tp (its bias added after);
- a LayerNorm over split features reduces its statistics over tp;
- where a layer needs the whole of a split activation (two column layers
  in a row, a replicated layer, the head's output) it is gathered, an
  all_reduce of a zero-padded buffer.

Gradients of split parameters are each rank's slice, of the others the
same on every tp rank; ``global_norm`` sums the split ones over tp.
``convert.tp_unshard_state_dict`` / ``tp_shard_state_dict`` move a
state dict (parameters, and Adam's moments, which split as their
parameters) between the split and the whole form.  As in the JAX package,
only PPO places its nets over tp.
"""

import re
import types

import torch
import torch.distributed as dist
import torch.nn.functional as F

from rlx_tpu_torch.parallel.mesh import TP_AXIS

COLUMN = (None, TP_AXIS)
ROW = (TP_AXIS, None)
REPLICATED = ()

# the k of flax's Dense_k for a port parameter name: trunk layers by index,
# a head linear as its module's own Dense_0
_DENSE_WEIGHT = re.compile(r"(?:^|\.)layers\.(\d+)\.weight$|^(mean|logits|value|head)\.weight$")


def match_partition_rules(rules, named_params, default=REPLICATED):
    """``{name: spec}``: the spec of the first ``(regex, spec)`` of
    ``rules`` that ``re.search``es the name; single-element parameters are
    replicated."""
    specs = {}
    for name, param in named_params.items():
        spec = default
        if param.numel() > 1:
            for rule, rule_spec in rules:
                if re.search(rule, name):
                    spec = rule_spec
                    break
        specs[name] = REPLICATED if param.numel() <= 1 else spec
    return specs


def alternating_mlp_rules(named_params):
    """``{name: spec}``: every 2-D ``.weight`` column, row, column, ... in
    order; everything else replicated."""
    specs, k = {}, 0
    for name, param in named_params.items():
        if name.endswith(".weight") and param.ndim == 2:
            specs[name] = COLUMN if k % 2 == 0 else ROW
            k += 1
        else:
            specs[name] = REPLICATED
    return specs


def tp_specs_for_tree(named_params, tp_size=2):
    """``{name: spec}`` for a net's parameters (or Adam's moments, which
    share their names): every Dense weight column-split for even k,
    row-split for odd k, with the JAX package's fallback (the other
    orientation, then replication) where a width does not divide."""
    specs = {}
    for name, param in named_params.items():
        m = _DENSE_WEIGHT.search(name)
        if m and param.ndim == 2:
            k = int(m.group(1)) if m.group(1) is not None else 0
            out_features, in_features = param.shape
            col = COLUMN if out_features % tp_size == 0 else None
            row = ROW if in_features % tp_size == 0 else None
            preferred = col if k % 2 == 0 else row
            specs[name] = preferred or col or row or REPLICATED
        else:
            specs[name] = REPLICATED
    return specs


# ------------------------------------------------------------------ autograd


def _all_reduce(x, group):
    """A summed copy of ``x`` over ``group`` (half types summed in float32:
    gloo has no bfloat16 sum)."""
    wide = x.to(torch.promote_types(x.dtype, torch.float32))
    wide = wide.clone() if wide is x else wide
    dist.all_reduce(wide, group=group)
    return wide.to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    """Identity forward; backward all-reduces over tp (a whole input feeding
    split outputs: each rank holds part of its gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce forward (a row layer's partial sums); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _StatsFromTP(torch.autograd.Function):
    """All-reduce forward and backward (LayerNorm statistics over split
    features: every rank's output depends on every rank's features)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _GatherFromTP(torch.autograd.Function):
    """The whole last dim from every rank's slice (a zero-padded
    all_reduce); backward keeps this rank's slice of the (replicated)
    gradient."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.width = rank, x.shape[-1]
        out = torch.zeros(x.shape[:-1] + (x.shape[-1] * size,), dtype=x.dtype, device=x.device)
        out[..., rank * ctx.width:(rank + 1) * ctx.width] = x
        return _all_reduce(out, group)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.rank * ctx.width:(ctx.rank + 1) * ctx.width].contiguous(), None, None, None


class _ScatterToTP(torch.autograd.Function):
    """This rank's slice of the last dim; backward zero-pads this rank's
    gradient and all-reduces it into the whole input's."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group, ctx.rank, ctx.size = group, rank, size
        width = x.shape[-1] // size
        return x[..., rank * width:(rank + 1) * width].contiguous()

    @staticmethod
    def backward(ctx, grad):
        width = grad.shape[-1]
        out = torch.zeros(grad.shape[:-1] + (width * ctx.size,), dtype=grad.dtype, device=grad.device)
        out[..., ctx.rank * width:(ctx.rank + 1) * width] = grad
        return _all_reduce(out, ctx.group), None, None, None


# ------------------------------------------------------------------ modules


def _slice(tensor, dim, rank, size):
    width = tensor.shape[dim] // size
    return tensor.narrow(dim, rank * width, width).clone()


def split_axes(module, specs):
    """``{name: dim}`` of the parameters a tp rank holds a slice of: a
    column weight's dim 0 with its bias (and the LayerNorm after it), a row
    weight's dim 1."""
    axes = {}
    for name, spec in specs.items():
        if spec == COLUMN:
            axes[name] = 0
            base = name[: -len(".weight")]
            axes[base + ".bias"] = 0
            m = re.search(r"(^|.*\.)layers\.0\.weight$", name)
            if m and hasattr(_owner(module, m.group(1) + "norm"), "weight"):
                axes[m.group(1) + "norm.weight"] = 0
                axes[m.group(1) + "norm.bias"] = 0
        elif spec == ROW:
            axes[name] = 1
    return axes


def _owner(module, dotted):
    for part in dotted.rstrip(".").split(".") if dotted.rstrip(".") else []:
        module = getattr(module, part, None)
        if module is None:
            return None
    return module


def shard_module_(module, mesh):
    """Split ``module`` (a PPO ``GaussianPolicy``, ``CategoricalPolicy`` or
    ``VCritic`` with an MLP trunk) over ``mesh``'s tp group in place: each
    split parameter is replaced by this rank's slice and the forward by
    ``tp_forward``.  Returns ``{name: dim}`` of the split parameters."""
    from rlx_tpu_torch.models.mlp import MLP

    if not isinstance(getattr(module, "trunk", None), MLP) or module.trunk.norms is not None:
        raise NotImplementedError(f"tensor parallelism splits PPO's MLP nets, not {type(module).__name__}")
    named = dict(module.named_parameters())
    specs = tp_specs_for_tree(named, mesh.tp)
    axes = split_axes(module, specs)
    for name, dim in axes.items():
        owner = _owner(module, name.rsplit(".", 1)[0])
        leaf = name.rsplit(".", 1)[1]
        param = getattr(owner, leaf)
        owner._parameters[leaf] = torch.nn.Parameter(_slice(param.detach(), dim, mesh.tp_rank, mesh.tp),
                                                     requires_grad=param.requires_grad)
    module.tp_specs, module.tp_axes, module.tp_mesh = specs, axes, mesh
    module.forward = types.MethodType(tp_forward, module)
    return axes


def _head(module):
    for name in ("mean", "logits", "value"):
        if hasattr(module, name):
            return name, getattr(module, name)
    raise NotImplementedError(type(module).__name__)


def tp_forward(module, x):
    """The forward of a net split by ``shard_module_``: the MLP trunk (in
    its compute type, LayerNorm after the first Dense) and the head, each
    Dense column-, row- or un-split by its spec."""
    mesh = module.tp_mesh
    group, rank, size = mesh.tp_group, mesh.tp_rank, mesh.tp
    trunk = module.trunk
    dtype = trunk.compute_dtype or x.dtype
    x = x.to(dtype)
    split = False   # is x this rank's slice of its last dim?

    def gather(x):
        return _GatherFromTP.apply(x, group, rank, size)

    def dense(x, split, layer, spec, dtype):
        weight, bias = layer.weight.to(dtype), layer.bias.to(dtype)
        if spec == COLUMN:
            if split:
                x = gather(x)
            return F.linear(_CopyToTP.apply(x, group), weight, bias), True
        if spec == ROW:
            if not split:
                x = _ScatterToTP.apply(x, group, rank, size)
            return _ReduceFromTP.apply(F.linear(x, weight), group) + bias, False
        if split:
            x = gather(x)
        return F.linear(x, weight, bias), False

    for i, layer in enumerate(trunk.layers):
        x, split = dense(x, split, layer, module.tp_specs[f"trunk.layers.{i}.weight"], dtype)
        if i == 0 and trunk.norm is not None:
            x = _layer_norm(x.to(torch.promote_types(dtype, torch.float32)), trunk.norm, split, group,
                            x.shape[-1] * (size if split else 1)).to(dtype)
        x = trunk.activation(x)
    if trunk.compute_dtype:
        x = x.float()
    name, head = _head(module)
    x, split = dense(x, split, head, module.tp_specs[f"{name}.weight"], x.dtype)
    if split:
        x = gather(x)
    if name == "mean":
        return x, module.policy_logstd
    return x


def _layer_norm(x, norm, split, group, features):
    """``F.layer_norm`` over ``features``; over split features the mean and
    the variance are sums reduced over tp."""
    if not split:
        return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias, norm.eps)
    mean = _StatsFromTP.apply(x.sum(-1, keepdim=True), group) / features
    var = _StatsFromTP.apply(((x - mean) ** 2).sum(-1, keepdim=True), group) / features
    return (x - mean) * torch.rsqrt(var + norm.eps) * norm.weight + norm.bias


def global_norm(module, grads):
    """The global norm of a tp-split net's gradients (in
    ``module.parameters()`` order): the split parameters' squares summed
    over tp, the others counted once."""
    axes, mesh = module.tp_axes, module.tp_mesh
    names = [name for name, _ in module.named_parameters()]
    square = lambda g: torch.sum(g.to(torch.promote_types(g.dtype, torch.float32)) ** 2)
    split = sum((square(g) for n, g in zip(names, grads) if n in axes), torch.zeros((), device=grads[0].device))
    whole = sum((square(g) for n, g in zip(names, grads) if n not in axes), torch.zeros((), device=grads[0].device))
    split = split.to(whole.dtype) if split.dtype != whole.dtype else split
    dist.all_reduce(split, group=mesh.tp_group)
    return torch.sqrt(split + whole)


def clip_by_global_norm_(module, grads, max_norm):
    """``train_state.clip_by_global_norm_`` of a tp-split net (the norm of
    ``global_norm``); returns the unclipped norm."""
    norm = global_norm(module, grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm
