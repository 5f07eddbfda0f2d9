"""The port's packed replay buffer against the JAX package's: the same rows
written to both, then ``sample`` and ``sample_nstep`` with the indices that
JAX draws from a key handed to the port."""

import numpy as np
import pytest
import torch

from rlx_tpu_torch.ops import replay_buffer as rb
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

OBS, ACT = 3, 2


def _specs(float_dtype, int_dtype, bool_dtype):
    return {
        "observation": ((OBS,), float_dtype),
        "next_observation": ((OBS,), float_dtype),
        "action": ((ACT,), float_dtype),
        "reward": ((), float_dtype),
        "terminated": ((), float_dtype),
        "truncated": ((), float_dtype),
        "env_id": ((), int_dtype),
        "flag": ((), bool_dtype),
    }


def _rows(nr_rows, nr_envs, seed, done_rate):
    rng = np.random.default_rng(seed)
    return [{
        "observation": rng.normal(size=(nr_envs, OBS)).astype(np.float32),
        "next_observation": rng.normal(size=(nr_envs, OBS)).astype(np.float32),
        "action": rng.uniform(-1, 1, size=(nr_envs, ACT)).astype(np.float32),
        "reward": rng.normal(size=nr_envs).astype(np.float32),
        "terminated": (rng.random(nr_envs) < done_rate).astype(np.float32),
        "truncated": (rng.random(nr_envs) < done_rate).astype(np.float32),
        "env_id": np.arange(nr_envs, dtype=np.int32) + 100 * t,
        "flag": rng.random(nr_envs) < 0.5,
    } for t in range(nr_rows)]


def _fill(capacity, nr_envs, nr_rows, seed=0, done_rate=0.2):
    import jax.numpy as jnp

    from rlx_tpu.ops import replay_buffer as jax_rb

    ours = rb.create(capacity, nr_envs, _specs(torch.float32, torch.int32, torch.bool))
    ref = jax_rb.create(capacity, nr_envs, _specs(jnp.float32, jnp.int32, jnp.bool_))
    for row in _rows(nr_rows, nr_envs, seed, done_rate):
        rb.add(ours, {k: torch.tensor(v) for k, v in row.items()})
        ref = jax_rb.add(ref, {k: jnp.asarray(v) for k, v in row.items()})
    return ours, ref


def _assert_batches_equal(ours, ref):
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].numpy().dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_add_wraps_around_like_jax():
    ours, ref = _fill(capacity=4, nr_envs=3, nr_rows=6)
    assert (ours.pos, ours.size) == (int(ref.pos), int(ref.size)) == (2, 4)
    np.testing.assert_array_equal(ours.storage.numpy(), np.asarray(ref.storage))
    _assert_batches_equal(ours.data, ref.data)
    # rows 0 and 1 were overwritten by writes 4 and 5
    assert ours.data["env_id"][0, 0] == 400 and ours.data["env_id"][2, 0] == 200


@pytest.mark.parametrize("nr_rows", [3, 9])   # partly filled; full and wrapped
def test_sample_matches_jax_on_injected_indices(nr_rows):
    import jax

    from rlx_tpu.ops import replay_buffer as jax_rb

    ours, ref = _fill(capacity=6, nr_envs=4, nr_rows=nr_rows)
    key = jax.random.PRNGKey(3)
    expected = jax_rb.sample(ref, key, 32, shard_local=False)
    time_key, env_key = jax.random.split(key)
    t_idx = jax.random.randint(time_key, (32,), 0, ref.size)
    e_idx = jax.random.randint(env_key, (32,), 0, ref.nr_envs)
    batch = rb.sample(ours, None, 32, t_idx=torch.tensor(np.asarray(t_idx)).long(),
                      e_idx=torch.tensor(np.asarray(e_idx)).long())
    _assert_batches_equal(batch, expected)


# n_step 3 and 5 over a buffer that is partly filled, exactly full, or full
# and wrapped (write head re-based), with terminations and truncations
# inside the window; gamma**k is a power in f32 on both sides
@pytest.mark.parametrize("nr_rows,n_step", [(5, 3), (8, 3), (13, 3), (13, 5)])
def test_sample_nstep_matches_jax_on_injected_indices(nr_rows, n_step):
    import jax

    from rlx_tpu.ops import replay_buffer as jax_rb

    ours, ref = _fill(capacity=8, nr_envs=4, nr_rows=nr_rows, seed=nr_rows, done_rate=0.25)
    key = jax.random.PRNGKey(nr_rows)
    expected = jax_rb.sample_nstep(ref, key, 64, n_step, 0.97, shard_local=False)
    time_key, env_key = jax.random.split(key)
    t0 = jax.random.randint(time_key, (64,), 0, max(int(ref.size) - n_step + 1, 1))
    e_idx = jax.random.randint(env_key, (64,), 0, ref.nr_envs)
    batch = rb.sample_nstep(ours, None, 64, n_step, 0.97, t0=torch.tensor(np.asarray(t0)).long(),
                            e_idx=torch.tensor(np.asarray(e_idx)).long())
    assert set(batch) == set(expected)
    for k in expected:
        np.testing.assert_allclose(batch[k].numpy(), np.asarray(expected[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    # some windows were cut short: the discount is not gamma**n everywhere
    assert (batch["n_step_gamma"] > 0.97 ** n_step + 1e-6).any()


def test_samplers_draw_only_filled_rows():
    ours, _ = _fill(capacity=8, nr_envs=2, nr_rows=3)
    g = torch.Generator().manual_seed(0)
    ids = rb.sample(ours, g, 256)["env_id"]
    assert set(ids.tolist()) <= {e + 100 * t for t in range(3) for e in range(2)}
    nstep = rb.sample_nstep(ours, g, 256, 2, 0.9)
    assert nstep["observation"].shape == (256, OBS) and nstep["n_step_gamma"].max() <= 0.9 ** 1 + 1e-7


def test_write_head_and_fill_are_device_counts():
    """``pos`` and ``size`` are 0-dim int64 tensors on the storage's device,
    advanced in place: the same tensors before and after a wrap; the
    samplers' start rows are a device tensor too."""
    ours = rb.create(4, 3, _specs(torch.float32, torch.int32, torch.bool))
    pos, size = ours.pos, ours.size
    assert pos.shape == size.shape == () and pos.dtype == size.dtype == torch.int64
    for t, row in enumerate(_rows(6, 3, 0, 0.2)):
        rb.add(ours, {k: torch.tensor(v) for k, v in row.items()})
        assert ours.pos is pos and ours.size is size
        assert (int(pos), int(size)) == ((t + 1) % 4, min(t + 1, 4))
    assert rb.start_rows(ours, 1) is size
    assert isinstance(rb.start_rows(ours, 3), torch.Tensor) and int(rb.start_rows(ours, 3)) == 2


@pytest.mark.parametrize("nr_rows,n_step", [(9, 1), (13, 3)])   # wrapped once / 1.6 times at capacity 8
def test_add_and_sample_read_nothing_back_and_match_jax(nr_rows, n_step):
    """``add``, ``sample`` and ``sample_nstep`` under ``NoHostRead`` (what a
    captured learning step needs) across a wrap at capacity, the n-step
    rows re-based at the write head when full: the storage, head and fill
    and the batches for JAX's injected indices equal the JAX buffer's; the
    indices they draw themselves lie below the fill."""
    import jax
    import jax.numpy as jnp

    from rlx_tpu.ops import replay_buffer as jax_rb
    from torch_parity import NoHostRead

    capacity, nr_envs = 8, 4
    rows = _rows(nr_rows, nr_envs, nr_rows, 0.25)
    ours = rb.create(capacity, nr_envs, _specs(torch.float32, torch.int32, torch.bool))
    ref = jax_rb.create(capacity, nr_envs, _specs(jnp.float32, jnp.int32, jnp.bool_))
    tensors = [{k: torch.tensor(v) for k, v in row.items()} for row in rows]
    generator = torch.Generator().manual_seed(nr_rows)
    key = jax.random.PRNGKey(nr_rows)
    time_key, env_key = jax.random.split(key)
    high = max(min(nr_rows, capacity) - n_step + 1, 1)
    t_idx = torch.tensor(np.asarray(jax.random.randint(time_key, (64,), 0, high))).long()
    e_idx = torch.tensor(np.asarray(jax.random.randint(env_key, (64,), 0, nr_envs))).long()
    with NoHostRead():
        for row in tensors:
            rb.add(ours, row)
        if n_step > 1:
            batch = rb.sample_nstep(ours, None, 64, n_step, 0.97, t0=t_idx, e_idx=e_idx)
            drawn = rb.sample_nstep(ours, generator, 256, n_step, 0.97)
        else:
            batch = rb.sample(ours, None, 64, t_idx=t_idx, e_idx=e_idx)
            drawn = rb.sample(ours, generator, 256)
    for row in rows:
        ref = jax_rb.add(ref, {k: jnp.asarray(v) for k, v in row.items()})
    assert (int(ours.pos), int(ours.size)) == (int(ref.pos), int(ref.size)) == (nr_rows % capacity, capacity)
    np.testing.assert_array_equal(ours.storage.numpy(), np.asarray(ref.storage))
    if n_step > 1:
        expected = jax_rb.sample_nstep(ref, key, 64, n_step, 0.97, shard_local=False)
        for k in expected:
            np.testing.assert_allclose(batch[k].numpy(), np.asarray(expected[k]), rtol=1e-6, atol=1e-6, err_msg=k)
        # a drawn window starts at one of the oldest size - n_step + 1 rows
        # (re-based at the write head): never at the newest n_step - 1
        starts = {tuple(o) for row in rows[nr_rows - capacity:nr_rows - n_step + 1] for o in
                  row["observation"].tolist()}
        seen = {tuple(o) for o in drawn["observation"].tolist()}
        assert seen <= starts and len(seen) > len(starts) // 2
    else:
        _assert_batches_equal(batch, jax_rb.sample(ref, key, 64, shard_local=False))
        # every row written after the wrap is there to draw, none from before it
        ids = set(drawn["env_id"].tolist())
        assert ids <= {e + 100 * t for t in range(nr_rows - capacity, nr_rows) for e in range(nr_envs)}


def test_draw_indices_are_uniform_below_a_device_high():
    """Below a 0-dim tensor, ``floor(u * high)`` from float64 uniforms:
    every index below ``high``, each within 5 standard deviations of its
    expected count; below a host int, ``torch.randint``'s draws."""
    high, n = 7, 70_000
    draws = rb.draw_indices(torch.Generator().manual_seed(1), torch.tensor(high), n, "cpu")
    u = torch.rand((n,), generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    assert draws.dtype == torch.int64 and torch.equal(draws, (u * high).long())
    counts = torch.bincount(draws, minlength=high)
    assert counts.shape == (high,) and int(draws.max()) == high - 1 and int(draws.min()) == 0
    expected, sd = n / high, (n / high * (1 - 1 / high)) ** 0.5
    assert (counts.double() - expected).abs().max() < 5 * sd
    host = rb.draw_indices(torch.Generator().manual_seed(1), high, n, "cpu")
    assert torch.equal(host, torch.randint(0, high, (n,), generator=torch.Generator().manual_seed(1)))
