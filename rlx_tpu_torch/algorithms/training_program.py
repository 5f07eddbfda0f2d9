"""The training run as a host loop over eval/save iterations.

Every algorithm's run is ``nr_eval_save_iterations`` calls of
``model._eval_save_iteration(carry, i)`` from ``model._init_train_carry()``,
as in the JAX package (``rlx_tpu/algorithms/training_program.py``).  JAX
runs it either fused (one jitted scan over the whole run) or chunked (one
device call per eval/save iteration, ``runner.chunked_train=True``); its
``tests/test_chunked_train.py`` pins both modes to the same eval history.
The eager port has no fused program: it always runs the chunked loop, one
host call per eval/save iteration, and accepts ``runner.chunked_train`` with
either value.

Each ``train()`` call starts from a fresh env reset (``train_reset_seed``).
"""

import numpy as np
import torch


def run_training_program(model):
    """-> (final_carry, eval_history).

    ``eval_history`` maps each eval metric to a numpy array of
    ``[nr_eval_save_iterations]`` values, or is None when evaluation is
    inactive.
    """
    carry = model._init_train_carry()
    evals = []
    for i in range(model.nr_eval_save_iterations):
        carry, eval_metrics = model._eval_save_iteration(carry, i)
        if eval_metrics is not None:
            evals.append(eval_metrics)
    eval_history = {k: np.asarray([e[k] for e in evals]) for k in evals[0]} if evals else None
    return carry, eval_history


def train_reset_seed(model):
    """The seed of the env reset that starts a ``train()`` call: the
    environment's seed on the model's first call, a fresh draw from
    ``model.host_generator`` on every later one (the JAX package splits a
    fresh reset key off the model's key for every call)."""
    model.nr_train_resets += 1
    if model.nr_train_resets == 1:
        return model.seed
    return int(torch.randint(2**31 - 1, (), generator=model.host_generator))
