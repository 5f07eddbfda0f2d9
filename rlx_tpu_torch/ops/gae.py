"""Generalized Advantage Estimation over time-major ``[T, B]`` arrays.

``terminations[t]`` is True when transition t ended in a true termination
(never truncation), and ``next_values`` come from the pre-auto-reset
observation (``final_observation``), so truncated episodes bootstrap.

A CUDA tensor goes through the hand-written kernel
(``rlx_tpu_torch.ops.gae_cuda``), a CPU tensor through
``gae_advantages_reference``, the kernel's plain version.
"""

import torch


def gae_advantages(rewards, values, next_values, terminations, gamma, gae_lambda):
    """Inputs ``[T, B]`` float32 (terminations bool, uint8 or float32).
    Returns (advantages, returns), both ``[T, B]``."""
    if rewards.is_cuda:
        from rlx_tpu_torch.ops.gae_cuda import gae_advantages_cuda

        return gae_advantages_cuda(rewards, values, next_values, terminations, gamma, gae_lambda)
    return gae_advantages_reference(rewards, values, next_values, terminations, gamma, gae_lambda)


def gae_advantages_reference(rewards, values, next_values, terminations, gamma, gae_lambda):
    """Eager reverse loop over T on any device (the kernel's plain version)."""
    nonterminal = 1.0 - terminations.to(rewards.dtype)
    deltas = rewards + gamma * next_values * nonterminal - values
    gamma_lambda = float(gamma) * float(gae_lambda)
    advantages = torch.empty_like(deltas)
    advantage = torch.zeros_like(deltas[0])
    for t in reversed(range(deltas.shape[0])):
        advantage = deltas[t] + gamma_lambda * nonterminal[t] * advantage
        advantages[t] = advantage
    return advantages, advantages + values
