"""Two checkouts of the port on the eager off-policy learning step, on the card.

    python tools/offpolicy_eager_ab.py PARENT CHANGE [--rounds 2] [--steps 16] [--repeats 5]

Each of ``PARENT`` and ``CHANGE`` is a directory holding ``rlx_tpu_torch``.
Runs one process per checkout in the order PARENT CHANGE CHANGE PARENT,
``--rounds`` times, so that a drift of the shared host over the run falls
on both alike.  Each process measures FastTD3 (``chip_smoke.py`` phase 8's
shape: batch 8192, n_step 3, 101 atoms), TD3 and SAC (``bench_offpolicy``'s
batch 8192 and 512/256/128 nets) on ``locomotion.ant.cuda`` at 1024 envs a
seed, at one seed and at 4 parallel seeds: after the prefill that
``train()`` starts with and one window of warm-up, ``--repeats`` windows of
``--steps`` learning steps through the model's own ``_learning_step``
(eager at either seed count, on either checkout, from the count that
``train()`` makes: on a checkout that captures, a device count at one seed,
the captured step run eagerly, and a host count at 4 seeds), each window
timed between two synchronisations, then one profiled window for the
device operations (kernels, copies, fills) a step.  Prints one JSON line per
process and measurement, then the medians of each checkout's ms a step
and their ratio.  Needs a CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SHAPES = {
    "fasttd3": {"algorithm.batch_size": 8192, "algorithm.n_step": 3, "algorithm.nr_atoms": 101,
                "algorithm.v_min": -10.0, "algorithm.v_max": 10.0},
    **{name: {"algorithm.batch_size": 8192, "algorithm.policy_hidden_sizes": (512, 256, 128),
              "algorithm.critic_hidden_sizes": (512, 256, 128)} for name in ("td3", "sac")},
}


def measure(family, seeds, steps, repeats, nr_envs=1024):
    """{ms a step of each window, device operations a step} of ``family``'s
    eager learning step at ``seeds`` seeds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rlx_tpu_torch.config import create_model, make_config

    model = create_model(make_config(f"{family}.cuda", "locomotion.ant.cuda", **{
        "runner.device": "cuda", "environment.nr_envs": nr_envs, **SHAPES[family],
        "algorithm.learning_starts": nr_envs, "algorithm.buffer_size": 64 * nr_envs,
        "algorithm.total_timesteps": 2 * nr_envs, "algorithm.logging_frequency": nr_envs,
        "algorithm.evaluation_active": False, "algorithm.logging_active": False,
        "algorithm.nr_parallel_seeds": seeds}))
    # the prefill, as train() starts: a changed checkout holds the buffer on
    # the model and makes the count (``initial_step``), a parent passes the
    # buffer in the carry and counts on the host
    carry = model._init_train_carry()
    if hasattr(model, "initial_step"):
        (env_state, step, _), buffer = carry, model.buffer
    else:
        (buffer, env_state, _), step = carry, 0

    def window():
        nonlocal env_state, step
        for _ in range(steps):
            env_state, _ = model._learning_step(buffer, env_state, step)
            step = step + 1
        torch.cuda.synchronize()

    window()   # warm-up
    ms = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        window()
        ms.append((time.perf_counter() - t0) * 1e3 / steps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        window()
    ops = sum(e.device_type == DeviceType.CUDA for e in prof.events()) / steps
    return {"ms_a_step": ms, "device_ops_a_step": ops}


def child(args):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import rlx_tpu_torch

    for family in SHAPES:
        for seeds in (1, 4):
            row = measure(family, seeds, args.steps, args.repeats)
            print(json.dumps({"checkout": os.path.dirname(os.path.dirname(rlx_tpu_torch.__file__)),
                              "family": family, "seeds": seeds, **row}), flush=True)
            torch.cuda.empty_cache()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("checkouts", nargs="*")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--steps", type=int, default=16)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--child", action="store_true")
    args = parser.parse_args()
    if args.child:
        return child(args)
    parent, change = (os.path.abspath(c) for c in args.checkouts)
    rows = []
    for checkout in [parent, change, change, parent] * args.rounds:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", "--steps", str(args.steps),
                              "--repeats", str(args.repeats)], env={**os.environ, "PYTHONPATH": checkout},
                             cwd=checkout, capture_output=True, text=True, timeout=900)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode:
            sys.exit(f"{checkout}: exit {out.returncode}")
        for line in out.stdout.splitlines():
            print(line, flush=True)
            rows.append(json.loads(line))
    for family in SHAPES:
        for seeds in (1, 4):
            medians = {}
            for name, checkout in (("parent", parent), ("change", change)):
                mine = [r for r in rows if r["checkout"] == checkout and r["family"] == family and r["seeds"] == seeds]
                medians[name] = {"ms_a_step": statistics.median(ms for r in mine for ms in r["ms_a_step"]),
                                 "spread_of_process_medians": [statistics.median(r["ms_a_step"]) for r in mine],
                                 "device_ops_a_step": mine[0]["device_ops_a_step"]}
            print(json.dumps({"family": family, "seeds": seeds, **medians,
                              "change_over_parent": medians["change"]["ms_a_step"] / medians["parent"]["ms_a_step"]}))


if __name__ == "__main__":
    main()
