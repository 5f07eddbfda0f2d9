"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits nonzero):

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``rlx_tpu_torch/csrc`` (nvcc, sm_90a);
3. kernel B1 (GAE) against its plain version at [64, 4096] and [64, 4097];
4. kernel B2 (physics substep) against ``engine.step_reference`` on the Ant
   at B=4096, 4 substeps: entry-pose anchors, given anchors, and every
   DomainParams field set;
5. PPO on ``locomotion.ant.cuda`` at the flagship size (4096 envs x 64
   steps, minibatch 32768, 4 epochs, 512/256/128 ELU+LayerNorm policy and
   critic, bf16 trunk) for 3 iterations through the runner's entry points,
   with the kernels' launch counters proving the path went through them;
6. one more PPO iteration under torch.profiler: wall time, device busy
   time and idle share, per-phase host spans, the top kernels by device time.

The line before the last is the kernels' JSON record, the last line the
device record.  Needs a CUDA device; never falls back to the CPU.
"""

import json
import math
import os
import subprocess
import sys
import time

import torch

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, H100 SXM data sheet
ITERATIONS = 3


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(outs, refs, rtol, atol, what):
    """Max |out - ref| over pairs; fails where |out - ref| > atol + rtol |ref|."""
    worst = 0.0
    for o, r in zip(outs, refs):
        if o.shape != r.shape:
            fail(f"{what}: shape {tuple(o.shape)} != {tuple(r.shape)}")
        if not torch.isfinite(o).all():
            fail(f"{what}: non-finite output")
        diff = (o - r).abs()
        if (diff > atol + rtol * r.abs()).any():
            fail(f"{what}: max |err| {diff.max().item():.3g} beyond rtol={rtol} atol={atol}")
        worst = max(worst, diff.max().item())
    return worst


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke runs the CUDA kernels and has no CPU fallback")
    dev = torch.device("cuda")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)

    # 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)

    from rlx_tpu_torch.ops import _build
    from rlx_tpu_torch.ops.engine_substep_cuda import step_cuda, substep_bytes, substep_flops
    from rlx_tpu_torch.ops.gae import gae_advantages_reference
    from rlx_tpu_torch.ops.gae_cuda import gae_advantages_cuda, gae_bytes
    from rlx_tpu_torch.physics import engine, load_model
    from rlx_tpu_torch.environments.locomotion.ant.cuda.environment import ANT_MODEL

    # 2. build
    t0 = time.perf_counter()
    report = _build.build_all()
    resources = {
        name: [line.replace("ptxas info    :", "").strip() for line in out.splitlines()
               if "registers" in line or "stack frame" in line]
        for name, (_, out) in report.items()
    }
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(report)} {json.dumps(resources)}")

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    kernels = []

    # 3. B1: GAE
    gae_err, gae_times = 0.0, None
    for B in (4096, 4097):
        r, v, nv = (torch.randn(64, B, device=dev, generator=g) for _ in range(3))
        d = torch.rand(64, B, device=dev, generator=g) < 0.05
        out = gae_advantages_cuda(r, v, nv, d, 0.99, 0.95)
        ref = gae_advantages_reference(r, v, nv, d, 0.99, 0.95)
        torch.cuda.synchronize()
        gae_err = max(gae_err, max_err(out, ref, 1e-5, 1e-5, f"GAE [64, {B}]"))
        if B == 4096:
            gae_times = (time_ms(lambda: gae_advantages_cuda(r, v, nv, d, 0.99, 0.95), 200),
                         time_ms(lambda: gae_advantages_reference(r, v, nv, d, 0.99, 0.95), 20))
    gae_bound = gae_bytes(64, 4096) / H100_BYTES_PER_S * 1e3
    print(f"B1 gae: max|err| {gae_err:.3g} (rtol=atol=1e-5, f32) kernel {gae_times[0]:.4f} ms "
          f"plain {gae_times[1]:.3f} ms bound {gae_bound:.4f} ms at [64, 4096]")
    kernels.append(dict(
        name="gae", route="cuda", source="rlx_tpu_torch/csrc/gae.cu",
        replaces="rlx_tpu/ops/gae_pallas.py:53", ms=gae_times[0], plain_ms=gae_times[1],
        bound_ms=gae_bound, bound_by="bytes", library_ms=None, max_abs_err=gae_err,
    ))

    # 4. B2: physics substep on the Ant
    model = load_model(ANT_MODEL)
    B, S = 4096, 4
    qpos0 = torch.as_tensor(model.qpos0, device=dev)
    qpos = qpos0.repeat(B, 1) + 0.1 * torch.randn(B, model.nq, device=dev, generator=g)
    qpos[:, 2] = 0.55 + 0.2 * torch.rand(B, device=dev, generator=g)
    qpos[:, 3:7] /= qpos[:, 3:7].norm(dim=1, keepdim=True)
    qvel = 0.5 * torch.randn(B, model.nv, device=dev, generator=g)
    ctrl = qpos0[7:] + 0.3 * (2.0 * torch.rand(B, 8, device=dev, generator=g) - 1.0)
    anchors = engine.contact_anchor_init(model, qpos)
    u = lambda *shape: 0.8 + 0.4 * torch.rand(*shape, device=dev, generator=g)
    nu = len(model.act_dof)
    dr = engine.DomainParams(
        mass_scale=u(model.nbody, B), damping_scale=u(B), frictionloss_scale=u(B),
        armature_scale=u(B), friction_scale=u(B), contact_stiffness_scale=u(B),
        kp_scale=u(nu, B), kv_scale=u(nu, B), forcerange_scale=u(nu, B),
        ctrl_offset=0.1 * (u(nu, B) - 1.0),
        gravity=torch.tensor([0.0, 0.0, -9.81], device=dev)[:, None] * u(B),
    )
    # f32 on both sides, but the kernel sums in another order and contracts
    # multiply-adds, and the stiff contact penalties amplify those roundings
    # over 4 substeps: 1e-4 relative + absolute.
    rtol = atol = 1e-4
    step_err = 0.0
    for label, kw in (("entry-pose anchors", {}), ("given anchors", {"contact_state": anchors}),
                      ("all DomainParams", {"contact_state": anchors, "dr": dr})):
        out = step_cuda(model, qpos, qvel, ctrl, nr_substeps=S, **kw)
        ref = engine.step_reference(model, qpos, qvel, ctrl, nr_substeps=S, **kw)
        torch.cuda.synchronize()
        step_err = max(step_err, max_err(out, ref, rtol, atol, f"substep ({label})"))
    step_ms = time_ms(lambda: step_cuda(model, qpos, qvel, ctrl, nr_substeps=S), 100)
    step_plain_ms = time_ms(lambda: engine.step_reference(model, qpos, qvel, ctrl, nr_substeps=S), 3)
    flops = substep_flops(model) * B * S
    nbytes = substep_bytes(model, B, with_anchors=False)
    step_bound = max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS) * 1e3
    bound_by = "bytes" if nbytes / H100_BYTES_PER_S > flops / H100_F32_FLOPS else "operations"
    print(f"B2 engine_substep: max|err| {step_err:.3g} (rtol=atol=1e-4) kernel {step_ms:.4f} ms "
          f"plain {step_plain_ms:.2f} ms bound {step_bound:.5f} ms ({bound_by}: {flops} flops, "
          f"{nbytes} bytes) at B={B}, {S} substeps")
    kernels.append(dict(
        name="engine_substep", route="cuda", source="rlx_tpu_torch/csrc/engine_substep.cu",
        replaces="rlx_tpu/ops/engine_substep_pallas.py:82", ms=step_ms, plain_ms=step_plain_ms,
        bound_ms=step_bound, bound_by=bound_by, library_ms=None, max_abs_err=step_err,
    ))

    # 5. train: the main path through the runner's entry points
    from rlx_tpu_torch.config import create_model, make_config
    from rlx_tpu_torch.utils.logging import setup_logger

    setup_logger()
    nr_envs, nr_steps = 4096, 64
    batch = nr_envs * nr_steps
    config = make_config("ppo.cuda", "locomotion.ant.cuda", **{
        "runner.device": "cuda",
        "environment.nr_envs": nr_envs,
        "algorithm.nr_steps": nr_steps,
        "algorithm.total_timesteps": ITERATIONS * batch,
        "algorithm.minibatch_size": batch // 8,
        "algorithm.nr_epochs": 4,
        "algorithm.policy_hidden_sizes": (512, 256, 128),
        "algorithm.critic_hidden_sizes": (512, 256, 128),
        "algorithm.activation": "elu",
        "algorithm.layer_norm": True,
        "algorithm.compute_dtype": "bfloat16",
    })
    model = create_model(config)
    step_cuda.launches = 0
    gae_advantages_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.train()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"engine_substep": step_cuda.launches, "gae": gae_advantages_cuda.launches}
    if launches != {"engine_substep": nr_steps * ITERATIONS, "gae": ITERATIONS}:
        fail(f"launch counts {launches} != {nr_steps * ITERATIONS} substep and {ITERATIONS} GAE")
    history = model.metrics_history
    if len(history) != ITERATIONS:
        fail(f"{len(history)} iterations logged, expected {ITERATIONS}")
    for it, metrics in enumerate(history):
        for k, v in metrics.items():
            if k.startswith("loss/") and not math.isfinite(v):
                fail(f"iteration {it}: {k} = {v}")
    for p in list(model.policy.module.parameters()) + list(model.critic.parameters()):
        if not torch.isfinite(p).all():
            fail("non-finite parameters after training")
    print(f"train: {ITERATIONS} PPO iterations at {nr_envs}x{nr_steps}, "
          f"{ITERATIONS * batch / elapsed:.0f} env-steps/s overall, "
          f"{history[-1]['time/sps']} env-steps/s in the last iteration, launches {launches}, "
          f"last losses " + json.dumps({k: v for k, v in history[-1].items() if k.startswith('loss/')}))

    # 6. where the time goes: one more iteration under the profiler (after
    # the counts above were read)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.env_state, _ = model.learning_iteration(model.env_state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # A record_function span shows up twice: as a CPU event (host time) and
    # as a GPU annotation (first to last kernel it launched).  Device busy
    # time sums only the kernels, which run one at a time on this stream.
    events = prof.events()
    cpu_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    kernel_ms, host_spans_ms, device_spans_ms = {}, {}, {}
    for e in events:
        ms = e.time_range.elapsed_us() / 1e3
        if e.name.startswith("ppo/"):
            spans = host_spans_ms if e.device_type == DeviceType.CPU else device_spans_ms
            spans[e.name] = spans.get(e.name, 0.0) + ms
        elif e.device_type == DeviceType.CUDA and e.name not in cpu_names:
            kernel_ms[e.name] = kernel_ms.get(e.name, 0.0) + ms
    busy_ms = sum(kernel_ms.values())
    top = sorted(kernel_ms.items(), key=lambda kv: -kv[1])[:6]
    print("profile: " + json.dumps({
        "iteration_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms, "host_spans_ms": host_spans_ms,
        "device_spans_ms": device_spans_ms, "top_kernels_ms": {k[:60]: v for k, v in top},
    }))

    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
