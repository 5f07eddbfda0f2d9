"""Running normalizers as plain dicts of tensors.

The same semantics as the JAX package's ``ops/normalizers.py``: a
Welford-merged running mean and population variance for observations, and
a discounted-return RMS with a G_max floor for rewards.  Counts start at
1e-4.  ``*_update`` returns a new state and leaves the old one as it was;
``obs_normalizer_update_`` writes the same values into the state's own
tensors (a model whose learning iteration a CUDA graph captures keeps one
set of tensors).
"""

import torch


def obs_normalizer_init(shape, device="cpu"):
    return {
        "mean": torch.zeros(shape, device=device),
        "var": torch.ones(shape, device=device),
        "count": torch.tensor(1e-4, device=device),
    }


def _moments(x, mesh):
    """(mean, biased variance, count) of ``x``'s rows; on a dp ``mesh`` over
    every rank's rows (a sum and a count, then the squared deviations)."""
    if mesh is None or mesh.dp == 1:
        return x.mean(dim=0), x.var(dim=0, unbiased=False), float(x.shape[0])
    count = float(x.shape[0] * mesh.dp)
    mean = mesh.all_reduce_sum(x.sum(dim=0)) / count
    return mean, mesh.all_reduce_sum(((x - mean) ** 2).sum(dim=0)) / count, count


def obs_normalizer_update(state, batch, mesh=None):
    """Welford parallel merge with a batch of observations [B, obs] (on a dp
    ``mesh`` every rank's rows)."""
    batch_mean, batch_var, batch_count = _moments(batch, mesh)
    delta = batch_mean - state["mean"]
    total = state["count"] + batch_count
    new_mean = state["mean"] + delta * batch_count / total
    m2 = (state["var"] * state["count"] + batch_var * batch_count
          + delta ** 2 * state["count"] * batch_count / total)
    return {"mean": new_mean, "var": m2 / total, "count": total}


def obs_normalizer_update_(state, batch, mesh=None):
    """``obs_normalizer_update`` written into ``state``'s tensors, in place;
    returns ``state``."""
    for key, value in obs_normalizer_update(state, batch, mesh).items():
        state[key].copy_(value)
    return state


def obs_normalize(state, observation, epsilon=1e-8):
    return (observation - state["mean"]) / torch.sqrt(state["var"] + epsilon)


def reward_normalizer_init(nr_envs, device="cpu"):
    return {
        "g": torch.zeros(nr_envs, device=device),
        "g_max": torch.zeros((), device=device),
        "mean": torch.zeros((), device=device),
        "var": torch.ones((), device=device),
        "count": torch.tensor(1e-4, device=device),
    }


def reward_normalizer_update(state, reward, terminated, truncated, gamma, mesh=None):
    """The running return ``g`` of each env (this dp rank's on a ``mesh``)
    and the statistics of every env's (every rank's)."""
    done = (terminated | truncated).to(torch.float32)
    g = gamma * (1.0 - done) * state["g"] + reward
    largest = torch.abs(g).max()
    if mesh is not None and mesh.dp > 1:
        largest = mesh.gather_rows(largest[None]).max()
    g_max = torch.maximum(state["g_max"], largest)
    sample_mean, sample_var, sample_count = _moments(g, mesh)
    delta = sample_mean - state["mean"]
    total = state["count"] + sample_count
    ratio = sample_count / total
    new_mean = state["mean"] + delta * ratio
    m2 = state["var"] * state["count"] + sample_var * sample_count + delta ** 2 * state["count"] * ratio
    return {"g": g, "g_max": g_max, "mean": new_mean, "var": m2 / total, "count": total}


def reward_normalize(state, reward, normalized_g_max=10.0, epsilon=1e-8):
    denom = torch.maximum(torch.sqrt(state["var"] + epsilon), state["g_max"] / normalized_g_max)
    return reward / denom
