"""On-device circular replay buffer, packed for single-gather sampling.

The same layout and semantics as the JAX package's ``ops/replay_buffer.py``:

- when every field is flat (rank <= 1) and 4-byte numeric (float32, int32
  or bool), all of them are stored in ONE env-major ``[nr_envs, capacity,
  D]`` float32 tensor, so a uniform sample is a single row gather.  int32
  fields round-trip exactly only below 2**24;
- otherwise (image observations, uint8 rows) each field is its own
  ``[capacity, nr_envs, ...]`` tensor of its own type (``layout`` is
  None), written in place, and a sample is one gather per field;
- ``sample`` draws (time, env) uniformly; ``sample_nstep`` reads ``n_step``
  consecutive rows with the write head re-based when the buffer is full and
  the sequence cut at terminations and truncations.

There is one device, so the JAX package's shard-local env sampling with one
shard is plain uniform sampling and has no keyword here.  Unlike the JAX
package's immutable buffer, ``add`` writes in place (the storage is the
largest tensor of a run).  The write head ``pos`` and the fill count
``size`` are 0-dim int64 tensors on the storage's device, updated in place,
as the JAX buffer's int32 arrays, and ``add`` writes at the device index;
the samplers draw their time indices below the device fill, so nothing is
read back to the host and a CUDA graph can capture a learning step.  Both
samplers take a ``torch.Generator`` and optional explicit indices, so a
test can replay another implementation's draws.

An index below a device ``high`` is ``floor(u * high)`` from a float64
uniform ``u`` in [0, 1) (``draw_indices``; ``torch.randint`` takes no
tensor ``high``): uniform to within float64 rounding, a 2**-53 share of a
row, the same formula on the CPU and on the card.  Below a host int (the
env index) it is ``torch.randint``'s.
"""

import torch

_PACKABLE_DTYPES = (torch.float32, torch.int32, torch.bool)


class ReplayBuffer:
    def __init__(self, storage, layout):
        # packed: [nr_envs, capacity, D] float32; unpacked: dict name ->
        # [capacity, nr_envs, ...] of the field's type
        self.storage = storage
        self.layout = layout     # ((name, offset, width, trailing_shape, dtype), ...) or None
        device = self.device
        self.pos = torch.zeros((), dtype=torch.int64, device=device)    # write head
        self.size = torch.zeros((), dtype=torch.int64, device=device)   # filled rows

    @property
    def packed(self):
        return self.layout is not None

    @property
    def nr_envs(self):
        return self.storage.shape[0] if self.packed else next(iter(self.storage.values())).shape[1]

    @property
    def capacity(self):
        return self.storage.shape[1] if self.packed else next(iter(self.storage.values())).shape[0]

    @property
    def data(self):
        """Per-field view ``[capacity, nr_envs, ...]``."""
        if not self.packed:
            return self.storage
        rows = self.storage.transpose(0, 1)
        return _unpack_rows(self.layout, rows, tuple(rows.shape[:2]))

    @property
    def device(self):
        return self.storage.device if self.packed else next(iter(self.storage.values())).device

    @property
    def nbytes(self):
        """Bytes the storage holds."""
        tensors = [self.storage] if self.packed else self.storage.values()
        return sum(t.numel() * t.element_size() for t in tensors)


def _build_layout(field_specs):
    """The packed layout, or None when a field is not flat and 4-byte."""
    layout, offset = [], 0
    for name, (shape, dtype) in field_specs.items():
        if len(shape) > 1 or dtype not in _PACKABLE_DTYPES:
            return None
        width = int(shape[0]) if shape else 1
        layout.append((name, offset, width, tuple(int(s) for s in shape), dtype))
        offset += width
    return tuple(layout)


def create(capacity, nr_envs, field_specs, device="cpu"):
    """``field_specs``: dict name -> (trailing_shape, dtype)."""
    layout = _build_layout(field_specs)
    if layout is None:
        return ReplayBuffer({name: torch.zeros((capacity, nr_envs) + tuple(shape), dtype=dtype, device=device)
                             for name, (shape, dtype) in field_specs.items()}, None)
    total = sum(width for _, _, width, _, _ in layout)
    return ReplayBuffer(torch.zeros((nr_envs, capacity, total), device=device), layout)


def set_data(buffer, data):
    """Replace every field's contents with ``data`` (name -> ``[capacity,
    nr_envs, ...]``), in place; the write head and fill count stay."""
    if not buffer.packed:
        for name, field in buffer.storage.items():
            field.copy_(data[name])
        return
    for name, off, width, _, _ in buffer.layout:
        rows = data[name].to(torch.float32).reshape(buffer.capacity, buffer.nr_envs, width)
        buffer.storage[..., off:off + width] = rows.transpose(0, 1)


def _pack_row(layout, transition, nr_envs):
    return torch.cat(
        [transition[name].to(torch.float32).reshape(nr_envs, width) for name, _, width, _, _ in layout],
        dim=-1,
    )


def _unpack_rows(layout, rows, batch_shape):
    """rows: [..., D] -> dict of [..., field_shape] tensors."""
    return {
        name: rows[..., off:off + width].reshape(batch_shape + shape).to(dtype)
        for name, off, width, shape, dtype in layout
    }


def add(buffer, transition):
    """Write one ``[nr_envs, ...]`` row per field at the device write head, in
    place (cast to each field's type); the head and the fill advance in
    place."""
    index = buffer.pos.reshape(1)
    if buffer.packed:
        buffer.storage.index_copy_(1, index, _pack_row(buffer.layout, transition, buffer.nr_envs)[:, None])
    else:
        for name, field in buffer.storage.items():
            field.index_copy_(0, index, transition[name].to(field.dtype)[None])
    buffer.pos.add_(1).remainder_(buffer.capacity)
    buffer.size.add_(1).clamp_(max=buffer.capacity)


def draw_indices(generator, high, batch_size, device):
    """``batch_size`` int64 indices uniform in [0, ``high``).  Below a 0-dim
    integer tensor (the device fill, read on the device): ``floor(u *
    high)`` with ``u`` a float64 uniform in [0, 1), kept below ``high``.
    Below a host int: ``torch.randint``."""
    if not isinstance(high, torch.Tensor):
        return torch.randint(0, high, (batch_size,), generator=generator, device=device)
    u = torch.rand((batch_size,), generator=generator, device=device, dtype=torch.float64)
    return torch.minimum((u * high).long(), high - 1)


def start_rows(buffer, n_step):
    """The rows a sample may start at, a 0-dim device tensor: the fill, or
    with ``n_step > 1`` the rows with ``n_step`` rows at or after them (at
    least 1)."""
    if n_step == 1:
        return buffer.size
    return torch.clamp(buffer.size - n_step + 1, min=1)


def sample(buffer, generator, batch_size, t_idx=None, e_idx=None):
    """Uniform sample of ``batch_size`` transitions -> dict of ``[batch, ...]``."""
    device = buffer.device
    if t_idx is None:
        t_idx = draw_indices(generator, start_rows(buffer, 1), batch_size, device)
    if e_idx is None:
        e_idx = draw_indices(generator, buffer.nr_envs, batch_size, device)
    if not buffer.packed:
        return {name: field[t_idx, e_idx] for name, field in buffer.storage.items()}
    rows = buffer.storage[e_idx, t_idx]                     # ONE [batch, D] gather
    return _unpack_rows(buffer.layout, rows, (batch_size,))


def sample_nstep(buffer, generator, batch_size, n_step, gamma, t0=None, e_idx=None):
    """n-step targets from consecutive rows with write-head patching.

    Returns the first transition's ``observation`` and ``action`` plus
    ``n_step_reward`` (the discounted sum), ``n_step_next_observation``,
    ``n_step_terminated`` and the effective discount ``n_step_gamma``.
    Needs the fields observation, next_observation, action, reward,
    terminated and truncated.
    """
    device = buffer.device
    if t0 is None:
        # valid start rows: at least n_step rows before the write head when full
        t0 = draw_indices(generator, start_rows(buffer, n_step), batch_size, device)
    if e_idx is None:
        e_idx = draw_indices(generator, buffer.nr_envs, batch_size, device)

    # When the buffer is full the circular write head means "row pos-1" is
    # the newest; re-base indices so consecutive t0+k never wraps over the head.
    base = torch.where(buffer.size >= buffer.capacity, buffer.pos, 0)
    steps = torch.arange(n_step, device=device)
    rows = (base + t0[:, None] + steps[None, :]) % buffer.capacity     # [batch, n]
    if buffer.packed:
        seq = _unpack_rows(buffer.layout, buffer.storage[e_idx[:, None], rows], (batch_size, n_step))
    else:
        seq = {name: buffer.storage[name][rows, e_idx[:, None]] for name in ("reward", "terminated", "truncated")}

    # mask[k] = 1 while no termination/truncation happened strictly before k
    dones = torch.clamp(seq["terminated"] + seq["truncated"], 0.0, 1.0)
    alive = torch.cumprod(1.0 - dones, dim=1)
    mask = torch.cat([torch.ones_like(alive[:, :1]), alive[:, :-1]], dim=1)

    discounts = gamma ** steps[None, :]
    n_step_reward = (seq["reward"] * discounts * mask).sum(dim=1)

    last = torch.clamp((mask > 0).sum(dim=1) - 1, min=0)             # last live index
    batch = torch.arange(batch_size, device=device)
    if buffer.packed:
        first = {name: seq[name][:, 0] for name in ("observation", "action")}
        next_observation = seq["next_observation"][batch, last]
    else:
        # the wide fields are read at the rows used only
        first = {name: buffer.storage[name][rows[:, 0], e_idx] for name in ("observation", "action")}
        next_observation = buffer.storage["next_observation"][rows[batch, last], e_idx]
    return {
        **first,
        "n_step_reward": n_step_reward,
        "n_step_next_observation": next_observation,
        "n_step_terminated": seq["terminated"][batch, last],
        "n_step_gamma": gamma ** (last.to(torch.float32) + 1.0),
    }
