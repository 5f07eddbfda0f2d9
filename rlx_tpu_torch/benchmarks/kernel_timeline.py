"""When each warp or block of kernels B1 (GAE) and B3 (C51 projection)
starts and finishes its phases, at the main paths' shapes.

    python -m rlx_tpu_torch.benchmarks.kernel_timeline [--reps 20]

Builds ``csrc/gae.cu`` and ``csrc/projection.cu`` a second time with
``-DRLX_TIMELINE`` (one thread of each block (B1) or warp (B3) writes the
global timer at its phase boundaries, and its SM), runs each through its
wrapper on the path's input (B1: [64, 4096] as PPO's update hands it; B3:
FastTD3 targets at [8192, 101] -> 101, and 8 times as many rows, where the
card stays full and the span per row is the kernel's steady rate), and
prints one JSON line per kernel and shape for the last launch: its span
from the first start to the last end, and the 0/10/50/90/100th
percentiles, over blocks or warps, of the start (after the first), of each
phase's duration and of the end.  B1's phases
are the staging (loads and delta), the walk and the stores; B3's are the
loads with the run sums, the adds and the write.  The stamps cost time of
their own; the plain build's device time is ``chip_smoke.py``'s.  Needs a
CUDA device.
"""

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from rlx_tpu_torch.ops import _build
from rlx_tpu_torch.ops.gae_cuda import gae_advantages_cuda, gae_geometry
from rlx_tpu_torch.ops.projection_cuda import categorical_projection_cuda

PHASES = {"gae": ("staging", "walk", "stores"), "projection": ("loads_and_run_sums", "adds", "write")}


def build_timeline(name):
    src = os.path.join(_build.CSRC_DIR, name + ".cu")
    out = _build.library_path(name).replace(".so", "-timeline.so")
    if not os.path.exists(out):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DRLX_TIMELINE", "-o", out, src],
                       check=True, capture_output=True)
    return ctypes.CDLL(out)


def summary(name, stamps):
    """Span and percentiles (ns) of one launch's stamps, ``[units, 5]``:
    start, three phase ends, SM."""
    t = stamps.astype(np.int64)
    first = t[:, 0].min()
    pct = lambda x: [int(np.percentile(x, q)) for q in (0, 10, 50, 90, 100)]
    phases = {ph: pct(t[:, k + 1] - t[:, k]) for k, ph in enumerate(PHASES[name])}
    return {"kernel": name, "units": len(t), "sms": len(set(t[:, 4].tolist())),
            "span_ns": int(t[:, 3].max() - first), "start_ns": pct(t[:, 0] - first),
            "phase_ns": phases, "end_ns": pct(t[:, 3] - first)}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    T, B = 64, 4096
    r, v, nv = (torch.randn(T, B, device=dev, generator=g) for _ in range(3))
    d = torch.rand(T, B, device=dev, generator=g) < 0.05
    atoms = torch.linspace(-10.0, 10.0, 101, device=dev)

    def fasttd3_targets(n):
        gamma_n = 0.97 ** torch.randint(1, 4, (n, 1), device=dev, generator=g).float()
        done = (torch.rand(n, 1, device=dev, generator=g) < 0.1).float()
        z = 3.0 * torch.randn(n, 1, device=dev, generator=g) + gamma_n * (1.0 - done) * atoms[None]
        p = torch.softmax(2.0 * torch.randn(n, 101, device=dev, generator=g), dim=-1)
        return lambda: categorical_projection_cuda(z, p, -10.0, 10.0, 101)

    runs = [("gae", [T, B], lambda: gae_advantages_cuda(r, v, nv, d, 0.99, 0.95), gae_geometry(T, B).blocks)]
    runs += [("projection", [n, 101], fasttd3_targets(n), n) for n in (8192, 65536)]
    for name, shape, fn, units in runs:
        plain = _build.load(name)
        _build._loaded[name] = lib = build_timeline(name)
        lib.rlx_timeline_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        try:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
            stamps = np.zeros((units, 5), dtype=np.uint64)
            if lib.rlx_timeline_read(stamps.ctypes.data, units) != 0:
                raise RuntimeError(f"reading the {name} timeline failed")
        finally:
            _build._loaded[name] = plain
        print(json.dumps({"shape": shape, **summary(name, stamps)}))


if __name__ == "__main__":
    main()
