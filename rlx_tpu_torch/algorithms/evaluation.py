"""Test-mode episode collection, with the JAX package's ``nr_test_episodes``
semantics (``rlx_tpu/algorithms/evaluation.py``): run the batched eval env
and harvest per-env returns at real episode boundaries
(terminated | truncated), stopping once enough episodes are done."""

import torch

from rlx_tpu_torch.utils.logging import rlx_logger


def collect_test_returns(step_fn, carry, episodes, horizon, extract=lambda c: c):
    """Collect ``episodes`` completed-episode returns.

    ``step_fn(carry) -> carry`` advances the eval rollout by one env step;
    ``extract(carry) -> env_state`` exposes its env state (a recurrent
    policy's carry also holds the policy's recurrent state).  A
    cap of ``max(2 * episodes * horizon, horizon)`` steps guards against
    envs that never finish.  The done mask and the returns go to the host
    in one copy a step, the loop's only sync.
    """
    returns = []
    max_steps = max(2 * episodes * horizon, horizon)
    steps = 0
    while len(returns) < episodes and steps < max_steps:
        carry = step_fn(carry)
        steps += 1
        state = extract(carry)
        episode_return = state.info["rollout/episode_return"]
        done = (state.terminated | state.truncated).to(episode_return.dtype)
        done, episode_return = torch.stack([done, episode_return]).cpu().numpy()
        for value in episode_return[done > 0]:
            returns.append(float(value))
            rlx_logger.info(f"eval/episode_return: {returns[-1]:.2f}")
            if len(returns) >= episodes:
                break
    return returns[:episodes]
