"""The ("dp", "tp") device mesh on ``torch.distributed``: one process per
device, the port's counterpart of ``rlx_tpu/parallel/mesh.py``.

- ``dp``, data parallel: each dp rank holds its rows of the env batch (and
  of the replay, the eval envs and the update batch); gradients, batch
  statistics, metrics and eval returns are averaged over the dp group.
- ``tp``, tensor parallel: Linear layers split over the tp group, column
  then row (``parallel/partition.py``); only PPO places its nets over tp.

A run of one process makes no process group and changes nothing.  Under
``torchrun --nproc-per-node=N`` (or with ``WORLD_SIZE`` / ``RANK`` /
``LOCAL_RANK`` set by hand) ``initialize_distributed`` joins the group,
over ``runner.coordinator_address`` when it is set (``host:port`` or a
``tcp://`` / ``file://`` URL), else torchrun's ``MASTER_ADDR`` /
``MASTER_PORT``; each rank then uses ``cuda:{LOCAL_RANK}``.

Collectives: **only ``all_reduce`` and ``broadcast``**.  Gloo supports no
other collective on CUDA tensors, and the same code runs on gloo over CPU
tensors (the CPU tests), on gloo with two ranks sharing one card (NCCL
refuses two ranks on one device; a CUDA tensor's collective goes through
a host copy, ``_all_reduce``) and on NCCL over real cards.  An
all-gather is an all-reduce of a zero-padded buffer (``gather_rows``).

Draws are global: JAX's keys are, so a dp run draws what a dp = 1 run
draws.  Each rank draws the whole tensor from the same-seeded generator
and keeps its rows (``RankRows`` for the env's draws, ``Mesh.rows`` for
the algorithms' action noise, permutations and replay indices).  So with
shard-local options off, dp = k equals dp = 1 up to the order of the
reductions.
"""

import datetime
import os

import torch
import torch.distributed as dist

DP_AXIS = "dp"
TP_AXIS = "tp"

# a collective that waits longer than this fails instead of hanging
DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)


def world_size():
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank():
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_rank():
    return int(os.environ.get("LOCAL_RANK", rank()))


def initialize_distributed(coordinator_address="", backend=None, timeout=DEFAULT_TIMEOUT):
    """Join the process group that ``WORLD_SIZE`` / ``RANK`` describe (as
    torchrun sets them); a no-op at world size 1 or when a group exists.
    ``backend`` defaults to NCCL where CUDA is available, else gloo.
    Returns the world size."""
    size = int(os.environ.get("WORLD_SIZE", 1))
    if size == 1 or dist.is_initialized():
        return world_size()
    if coordinator_address:
        init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    else:
        init_method = "env://"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        # the kernels launch on the current device: make it this rank's
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", os.environ["RANK"])) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=size,
                            rank=int(os.environ["RANK"]), timeout=timeout)
    return size


def rank_device(device):
    """``cuda:{LOCAL_RANK}`` for a bare ``"cuda"`` in a group of several
    processes (modulo the cards there are, so ranks may share a card);
    ``device`` as it is otherwise."""
    if world_size() > 1 and device == "cuda" and torch.cuda.is_available():
        return f"cuda:{local_rank() % torch.cuda.device_count()}"
    return device


class Mesh:
    """This process's place in the (dp, tp) mesh: sizes, ranks and groups.

    ``dp == tp == 1`` is the mesh of one device: no group, every helper
    an identity, whatever the world size (a process of a larger group may
    run a program of its own)."""

    def __init__(self, dp=1, tp=1, device_mesh=None):
        self.dp, self.tp = int(dp), int(tp)
        self.device_mesh = device_mesh
        if device_mesh is None:
            self.dp_group = self.tp_group = None
            self.dp_rank = self.tp_rank = 0
        else:
            self.dp_group = device_mesh.get_group(DP_AXIS)
            self.tp_group = device_mesh.get_group(TP_AXIS)
            self.dp_rank = device_mesh.get_local_rank(DP_AXIS)
            self.tp_rank = device_mesh.get_local_rank(TP_AXIS)

    @property
    def shape(self):
        return {DP_AXIS: self.dp, TP_AXIS: self.tp}

    def __repr__(self):
        return f"Mesh(dp={self.dp}, tp={self.tp}, dp_rank={self.dp_rank}, tp_rank={self.tp_rank})"

    # ----------------------------------------------------------------- rows
    def rows_of_rank(self, n):
        """(first, last + 1) of this dp rank's rows of ``n`` rows."""
        if n % self.dp:
            raise ValueError(f"{n} rows do not divide over dp = {self.dp}")
        per_rank = n // self.dp
        return self.dp_rank * per_rank, (self.dp_rank + 1) * per_rank

    def rows(self, x, dim=0):
        """This dp rank's rows of ``x`` along ``dim`` (a global draw)."""
        if self.dp == 1:
            return x
        lo, hi = self.rows_of_rank(x.shape[dim])
        return x.narrow(dim, lo, hi - lo)

    # ----------------------------------------------------------- collectives
    def all_reduce_mean_(self, tensors, group=DP_AXIS):
        """Average ``tensors`` (a list, each changed in place) over ``group``
        in one all_reduce of their flattened concatenation; returns them."""
        size, handle = self._group(group)
        tensors = [t for t in tensors if t is not None]
        if size == 1 or not tensors:
            return tensors
        flat = torch.cat([t.reshape(-1).to(torch.promote_types(t.dtype, torch.float32)) for t in tensors])
        _all_reduce(flat, handle)
        flat /= size
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].reshape(t.shape))
            offset += t.numel()
        return tensors

    def all_reduce_sum(self, x, group=DP_AXIS):
        """The sum of ``x`` over ``group`` (a new tensor)."""
        size, handle = self._group(group)
        if size == 1:
            return x
        x = x.clone()
        _all_reduce(x, handle)
        return x

    def mean(self, x, group=DP_AXIS):
        """The global mean of a per-rank mean over equal-sized shards."""
        size, _ = self._group(group)
        return x if size == 1 else self.all_reduce_sum(x, group) / size

    def mean_metrics(self, metrics):
        """A dict of per-rank means (device scalars) as global means, in one
        all_reduce; values off the metrics' device (a learning rate made on
        the host, equal on every rank) and non-tensors as they are."""
        if self.dp == 1:
            return metrics
        tensors = [v for v in metrics.values() if isinstance(v, torch.Tensor) and v.is_floating_point()]
        if not tensors:
            return metrics
        device = tensors[0].device
        keys = [k for k, v in metrics.items()
                if isinstance(v, torch.Tensor) and v.is_floating_point() and v.device == device]
        values = [metrics[k].detach().clone() for k in keys]
        self.all_reduce_mean_(values)
        return {**metrics, **dict(zip(keys, values))}

    def global_mean_var(self, x):
        """(mean, variance with ddof 0) of ``x`` over every dp rank's rows,
        as ``x.mean()`` and ``x.var(unbiased=False)`` of the concatenation:
        a sum and a count reduced, then the sum of squared deviations."""
        if self.dp == 1:
            return x.mean(), x.var(unbiased=False)
        total = self.all_reduce_sum(torch.stack([x.sum(), torch.tensor(float(x.numel()), dtype=x.dtype,
                                                                         device=x.device)]))
        mean = total[0] / total[1]
        var = self.all_reduce_sum(((x - mean) ** 2).sum()) / total[1]
        return mean, var

    def gather_rows(self, x, group=DP_AXIS):
        """Every rank's ``x`` (equal shapes) concatenated along dim 0 in rank
        order: an all-gather done as an all_reduce that sums a zero-padded
        buffer (exact: each element is one rank's value plus zeros)."""
        size, handle = self._group(group)
        if size == 1:
            return x
        r = self.dp_rank if group == DP_AXIS else self.tp_rank
        n = x.shape[0]
        buffer = torch.zeros((size * n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        buffer[r * n:(r + 1) * n] = x
        _all_reduce(buffer, handle)
        return buffer

    def broadcast_bytes(self, data):
        """Rank 0's ``data`` (bytes; ignored on the other ranks) on every
        rank of a mesh of several processes: its length, then the bytes as
        a uint8 tensor, each one broadcast; ``data`` as it is on the
        one-device mesh."""
        if self.dp * self.tp == 1:
            return data
        device = _collective_device()
        size = torch.tensor([len(data) if rank() == 0 else 0], dtype=torch.int64, device=device)
        dist.broadcast(size, src=0)
        if rank() == 0:
            buffer = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device)
        else:
            buffer = torch.empty(int(size.item()), dtype=torch.uint8, device=device)
        dist.broadcast(buffer, src=0)
        return buffer.cpu().numpy().tobytes()

    def barrier(self):
        """Every rank of a mesh of several processes waits for the others
        (an all_reduce of a zero: a save of rank 0's is done before any rank
        reads it); nothing on the one-device mesh."""
        if self.dp * self.tp == 1:
            return
        dist.all_reduce(torch.zeros(1, device=_collective_device()))

    def _group(self, group):
        if group == DP_AXIS:
            return self.dp, self.dp_group
        return self.tp, self.tp_group


SINGLE = Mesh()


def _all_reduce(x, group):
    """``dist.all_reduce`` of ``x`` over ``group``, in place.  Under gloo a
    CUDA tensor goes through a host copy, taken after the work queued
    before it and written back on the current stream, so the collective is
    ordered with the stream's work by these copies, not by gloo's own CUDA
    streams and events."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        host = x.cpu()
        dist.all_reduce(host, group=group)
        x.copy_(host)
    else:
        dist.all_reduce(x, group=group)


def _collective_device():
    """Where the default group's collectives take their tensors: this
    rank's card under NCCL, the CPU under gloo."""
    return torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else torch.device("cpu")


class _AllReduceSum(torch.autograd.Function):
    """A differentiable all_reduce: forward sums over the group, backward
    sums the gradients (every rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        _all_reduce(x, group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        _all_reduce(grad, ctx.group)
        return grad, None


def all_reduce_sum_autograd(x, mesh, group=DP_AXIS):
    """``mesh.all_reduce_sum`` with gradients (batch statistics, the
    row-parallel layers' outputs)."""
    size, handle = mesh._group(group)
    return x if size == 1 else _AllReduceSum.apply(x, handle)


def make_mesh(dp=None, tp=1, device_type="cpu"):
    """The global (dp, tp) mesh of this process group.  ``dp=None`` (or -1)
    takes every rank; ``dp * tp`` must be the world size, or 1 (a mesh of
    one device: no group).  Wraps ``init_device_mesh(device_type, (dp, tp),
    mesh_dim_names=("dp", "tp"))``."""
    size = world_size()
    tp = int(tp)
    if dp is None or dp == -1:
        dp = size // tp
    dp = int(dp)
    if dp * tp == 1:
        return SINGLE
    if dp * tp != size:
        raise ValueError(f"mesh (dp={dp}, tp={tp}) needs {dp * tp} processes, the group has {size} "
                         "(one process per device: launch with torchrun --nproc-per-node=dp*tp)")
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh(dp, tp, init_device_mesh(device_type, (dp, tp), mesh_dim_names=(DP_AXIS, TP_AXIS)))


_MESHES = {}


def mesh_for(config, device):
    """The mesh of ``runner.mesh_dp`` / ``runner.mesh_tp`` on ``device``'s
    type (made once per process and shape)."""
    runner = config.runner
    dp = runner.get("mesh_dp", -1)
    tp = runner.get("mesh_tp", 1)
    device_type = torch.device(device).type
    dp = world_size() // tp if dp == -1 else dp
    key = (dp, tp, device_type)
    if key not in _MESHES:
        _MESHES[key] = make_mesh(dp, tp, device_type)
    return _MESHES[key]


class RankRows:
    """An env state's generator under dp: ``environments/env.py::draw`` draws
    the global ``total`` rows from ``generator`` and keeps rows ``first ..
    first + n``, so each rank's envs draw what they draw at dp = 1."""

    def __init__(self, generator, first, total):
        self.generator, self.first, self.total = generator, int(first), int(total)

    def draw(self, sample, shape, **kwargs):
        from rlx_tpu_torch.environments.env import draw

        full = draw(self.generator, sample, (self.total,) + tuple(shape[1:]), **kwargs)
        return full[self.first:self.first + shape[0]]
