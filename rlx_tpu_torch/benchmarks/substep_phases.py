"""Where a warp of the physics-substep kernel spends its cycles, by phase.

    python -m rlx_tpu_torch.benchmarks.substep_phases [--batch 4096 1024]

Builds ``csrc/engine_substep.cu`` a second time with ``-DRLX_PHASE_CLOCKS``
(lane 0 of every env's group adds the ``clock64()`` cycles of each phase to
its block's counters, which go to device counters once per block), runs it
through ``step_cuda`` on the Ant at 4 substeps, and prints, per batch size
and lanes per env (32: one env a warp; 16: two), the plain build's time
(CUDA events around the wrapper, ``ms``), the occupancy calculator's
resident warps per SM, and the instrumented build's cycles per env and
substep of each phase (the group's wall time, stalls included) and their
shares.  The counters cost time of their own (``instrumented_ms``).  Needs
a CUDA device.
"""

import argparse
import ctypes
import json
import os
import subprocess

import torch

from rlx_tpu_torch.environments.locomotion.ant.cuda.environment import ANT_MODEL
from rlx_tpu_torch.ops import _build
from rlx_tpu_torch.ops import engine_substep_cuda as esc
from rlx_tpu_torch.physics import load_model

PHASES = ("load", "fk", "jacobian", "velocities", "contacts", "inertias_wrenches",
          "composite", "mass_matrix", "forces", "factor_solve", "back_solve", "integrate", "store")


def build_instrumented():
    src = os.path.join(_build.CSRC_DIR, "engine_substep.cu")
    out = _build.library_path("engine_substep").replace(".so", "-phases.so")
    if not os.path.exists(out):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DRLX_PHASE_CLOCKS", "-o", out, src],
                       check=True, capture_output=True)
    return ctypes.CDLL(out)


def _event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, nargs="+", default=[4096, 1024])
    parser.add_argument("--lanes", type=int, nargs="+", default=[32, 16])
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    model = load_model(ANT_MODEL)
    lib = build_instrumented()
    launch = esc.bind(lib)
    read = lib.rlx_engine_phase_cycles
    read.argtypes = [ctypes.c_void_p]
    plain_lib, policy = esc._lib, esc.lanes_per_env
    S = 4
    try:
        for B in args.batch:
            g = torch.Generator(device=dev).manual_seed(0)
            qpos = torch.as_tensor(model.qpos0, device=dev).repeat(B, 1)
            qpos[:, 2] += 0.1 * torch.rand(B, device=dev, generator=g)
            qvel = 0.5 * torch.randn(B, model.nv, device=dev, generator=g)
            ctrl = qpos[:, 7:] + 0.3 * torch.randn(B, 8, device=dev, generator=g)
            step = lambda: esc.step_cuda(model, qpos, qvel, ctrl, nr_substeps=S)
            for lanes in args.lanes:
                esc.lanes_per_env = lambda _, lanes=lanes: lanes
                esc._lib = plain_lib
                ms = _event_ms(step, args.reps)
                esc._lib = lambda: launch
                step()
                torch.cuda.synchronize()
                cycles = (ctypes.c_ulonglong * len(PHASES))()
                read(cycles)  # zero the counters
                instrumented_ms = _event_ms(step, args.reps)
                if read(cycles) != 0:
                    raise RuntimeError("reading the phase counters failed")
                # lane 0 of each env's group counts; reps + 1 launches since zeroing
                per = [c / ((args.reps + 1) * B * S) for c in cycles]
                total = sum(per)
                print(json.dumps({
                    "batch": B, "lanes_per_env": lanes, "substeps": S, "ms": ms,
                    "instrumented_ms": instrumented_ms,
                    "resident_warps_per_sm": esc.resident_warps_per_sm(model, lanes),
                    "cycles_per_env_substep": round(total, 1),
                    "phases": {n: [round(c, 1), round(c / total, 4)] for n, c in zip(PHASES, per)},
                }))
    finally:
        esc._lib, esc.lanes_per_env = plain_lib, policy


if __name__ == "__main__":
    main()
