"""On-device circular replay buffer, packed for single-gather sampling.

The same layout and semantics as the JAX package's ``ops/replay_buffer.py``:

- every field is flat (rank <= 1) and 4-byte numeric (float32, int32 or
  bool), and all of them are stored in ONE env-major
  ``[nr_envs, capacity, D]`` float32 tensor, so a uniform sample is a
  single row gather.  int32 fields round-trip exactly only below 2**24.
  Fields that cannot be packed (image observations) wait for the pixel
  track: ``create`` raises ``NotImplementedError`` for them;
- ``sample`` draws (time, env) uniformly; ``sample_nstep`` reads ``n_step``
  consecutive rows with the write head re-based when the buffer is full and
  the sequence cut at terminations and truncations.

There is one device, so the JAX package's shard-local env sampling with one
shard is plain uniform sampling and has no keyword here.  Unlike the JAX
package's immutable buffer, ``add`` writes in place (the storage is the
largest tensor of a run), and the write head and fill count are Python
ints, so sampling needs no device sync.  Both samplers take a
``torch.Generator`` and optional explicit indices, so a test can replay
another implementation's draws.
"""

import torch

_PACKABLE_DTYPES = (torch.float32, torch.int32, torch.bool)


class ReplayBuffer:
    def __init__(self, storage, layout):
        self.storage = storage   # [nr_envs, capacity, D] float32
        self.layout = layout     # ((name, offset, width, trailing_shape, dtype), ...)
        self.pos = 0             # write head
        self.size = 0            # filled rows

    @property
    def nr_envs(self):
        return self.storage.shape[0]

    @property
    def capacity(self):
        return self.storage.shape[1]

    @property
    def data(self):
        """Per-field view ``[capacity, nr_envs, ...]``."""
        rows = self.storage.transpose(0, 1)
        return _unpack_rows(self.layout, rows, tuple(rows.shape[:2]))


def _build_layout(field_specs):
    layout, offset = [], 0
    for name, (shape, dtype) in field_specs.items():
        if len(shape) > 1 or dtype not in _PACKABLE_DTYPES:
            raise NotImplementedError(
                f"field {name!r} ({tuple(shape)}, {dtype}) cannot be packed; the dict layout "
                "for image observations is not ported yet"
            )
        width = int(shape[0]) if shape else 1
        layout.append((name, offset, width, tuple(int(s) for s in shape), dtype))
        offset += width
    return tuple(layout)


def create(capacity, nr_envs, field_specs, device="cpu"):
    """``field_specs``: dict name -> (trailing_shape, dtype)."""
    layout = _build_layout(field_specs)
    total = sum(width for _, _, width, _, _ in layout)
    return ReplayBuffer(torch.zeros((nr_envs, capacity, total), device=device), layout)


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
    """Write one ``[nr_envs, ...]`` row per field at the write head, in place."""
    buffer.storage[:, buffer.pos] = _pack_row(buffer.layout, transition, buffer.nr_envs)
    buffer.pos = (buffer.pos + 1) % buffer.capacity
    buffer.size = min(buffer.size + 1, buffer.capacity)


def _randint(generator, high, batch_size, device):
    return torch.randint(0, high, (batch_size,), generator=generator, device=device)


def sample(buffer, generator, batch_size, t_idx=None, e_idx=None):
    """Uniform sample of ``batch_size`` transitions -> dict of ``[batch, ...]``."""
    device = buffer.storage.device
    if t_idx is None:
        t_idx = _randint(generator, buffer.size, batch_size, device)
    if e_idx is None:
        e_idx = _randint(generator, buffer.nr_envs, batch_size, device)
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
    device = buffer.storage.device
    if t0 is None:
        # valid start rows: at least n_step rows before the write head when full
        t0 = _randint(generator, max(buffer.size - n_step + 1, 1), batch_size, device)
    if e_idx is None:
        e_idx = _randint(generator, buffer.nr_envs, batch_size, device)

    # When the buffer is full the circular write head means "row pos-1" is
    # the newest; re-base indices so consecutive t0+k never wraps over the head.
    base = buffer.pos if buffer.size >= buffer.capacity else 0
    steps = torch.arange(n_step, device=device)
    rows = (base + t0[:, None] + steps[None, :]) % buffer.capacity     # [batch, n]
    seq = _unpack_rows(buffer.layout, buffer.storage[e_idx[:, None], rows], (batch_size, n_step))

    # mask[k] = 1 while no termination/truncation happened strictly before k
    dones = torch.clamp(seq["terminated"] + seq["truncated"], 0.0, 1.0)
    alive = torch.cumprod(1.0 - dones, dim=1)
    mask = torch.cat([torch.ones_like(alive[:, :1]), alive[:, :-1]], dim=1)

    discounts = gamma ** steps[None, :]
    n_step_reward = (seq["reward"] * discounts * mask).sum(dim=1)

    last = torch.clamp((mask > 0).sum(dim=1) - 1, min=0)             # last live index
    batch = torch.arange(batch_size, device=device)
    return {
        "observation": seq["observation"][:, 0],
        "action": seq["action"][:, 0],
        "n_step_reward": n_step_reward,
        "n_step_next_observation": seq["next_observation"][batch, last],
        "n_step_terminated": seq["terminated"][batch, last],
        "n_step_gamma": gamma ** (last.to(torch.float32) + 1.0),
    }
