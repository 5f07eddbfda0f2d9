"""Seed s of a parallel-seed run against its one-seed run over a learning
check's own settings, in float32 and float64 (not collected: no ``test_``
prefix; minutes on the CPU).

    python tests/torch_parallel_seeds_spread.py cartpole_spot_c51 --budget 25000

Trains the recipe (``rlx_tpu_torch.benchmarks.curves.RUNS``) at
``--seeds`` parallel seeds from ``environment.seed = 0`` and the one-seed
runs at ``seed_for(0, s)`` on the CPU, the evaluation off, for ``--budget``
env steps, and prints the max |err| of each seed's critic parameters
against its one-seed run's in each float type.  The seed-batched and the
one-seed products round apart, so in f32 the runs part as training
amplifies that rounding (an argmax that flips changes an episode); in
float64 they stay at float64 rounding unless the seed path computes
something else (another batch, draw, target refresh or schedule).
"""

import argparse
import json
import time

import torch

from rlx_tpu_torch.algorithms.parallel_seeds import seed_for
from rlx_tpu_torch.algorithms.training_program import run_training_program
from rlx_tpu_torch.benchmarks.curves import RUNS
from rlx_tpu_torch.config import create_model, make_config


def spread(name, budget, nr_seeds, dtype):
    spec = RUNS[name]
    default = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        def config(seed, seeds):
            return make_config(spec["algorithm"], spec["environment"], **{
                **spec["overrides"], "runner.device": "cpu", "algorithm.total_timesteps": budget,
                "algorithm.evaluation_active": False, "algorithm.logging_active": False,
                "algorithm.logging_frequency": 1000, "algorithm.evaluation_and_save_frequency": budget - 1000,
                "environment.seed": seed, "algorithm.nr_parallel_seeds": seeds})

        parallel = create_model(config(0, nr_seeds))
        run_training_program(parallel)
        stacked = dict(parallel.critic.module.named_parameters())
        errs = []
        for s in range(nr_seeds):
            one = create_model(config(seed_for(0, s), 1))
            one.train()
            errs.append(max((stacked[k][s] - v).abs().max().item() for k, v in one.critic.module.named_parameters()))
        return {"dtype": str(dtype), "updates": one.nr_updates, "max_abs_err_per_seed": errs}
    finally:
        torch.set_default_dtype(default)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("name", choices=sorted(RUNS))
    parser.add_argument("--budget", type=int, default=25_000)
    parser.add_argument("--seeds", type=int, default=3)
    args = parser.parse_args()
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        out = spread(args.name, args.budget, args.seeds, dtype)
        print(json.dumps({"name": args.name, "budget": args.budget, **out, "s": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
