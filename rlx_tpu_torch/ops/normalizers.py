"""Running normalizers as plain dicts of tensors.

The same semantics as the JAX package's ``ops/normalizers.py``: a
Welford-merged running mean and population variance for observations, and
a discounted-return RMS with a G_max floor for rewards.  Counts start at
1e-4.  ``*_update`` returns a new state and leaves the old one as it was.
"""

import torch


def obs_normalizer_init(shape, device="cpu"):
    return {
        "mean": torch.zeros(shape, device=device),
        "var": torch.ones(shape, device=device),
        "count": torch.tensor(1e-4, device=device),
    }


def obs_normalizer_update(state, batch):
    """Welford parallel merge with a batch of observations [B, obs]."""
    batch_mean = batch.mean(dim=0)
    batch_var = batch.var(dim=0, unbiased=False)
    batch_count = float(batch.shape[0])
    delta = batch_mean - state["mean"]
    total = state["count"] + batch_count
    new_mean = state["mean"] + delta * batch_count / total
    m2 = (state["var"] * state["count"] + batch_var * batch_count
          + delta ** 2 * state["count"] * batch_count / total)
    return {"mean": new_mean, "var": m2 / total, "count": total}


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


def reward_normalizer_update(state, reward, terminated, truncated, gamma):
    done = (terminated | truncated).to(torch.float32)
    g = gamma * (1.0 - done) * state["g"] + reward
    g_max = torch.maximum(state["g_max"], torch.abs(g).max())
    sample_mean = g.mean()
    sample_var = g.var(unbiased=False)
    sample_count = float(g.shape[0])
    delta = sample_mean - state["mean"]
    total = state["count"] + sample_count
    ratio = sample_count / total
    new_mean = state["mean"] + delta * ratio
    m2 = state["var"] * state["count"] + sample_var * sample_count + delta ** 2 * state["count"] * ratio
    return {"g": g, "g_max": g_max, "mean": new_mean, "var": m2 / total, "count": total}


def reward_normalize(state, reward, normalized_g_max=10.0, epsilon=1e-8):
    denom = torch.maximum(torch.sqrt(state["var"] + epsilon), state["g_max"] / normalized_g_max)
    return reward / denom
