"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits nonzero):

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``rlx_tpu_torch/csrc`` (nvcc, sm_90a);
3. kernel B1 (GAE) against its plain version at [64, 4096] and [64, 4097];
4. kernel B2 (physics substep) against ``engine.step_reference``, 4
   substeps: the Ant at B=4096 and B=1024 (the PPO and FastTD3 batches) and
   a ragged B=1000, with entry-pose and given anchors, every DomainParams
   field set, a ctrl_sequence, and the Ant without contacts / actuators;
   kernel, device, plain and bound times at both batches;
5. PPO on ``locomotion.ant.cuda`` at the flagship size (4096 envs x 64
   steps, minibatch 32768, 4 epochs, 512/256/128 ELU+LayerNorm policy and
   critic, bf16 trunk) for 3 iterations through the runner's entry points,
   with the kernels' launch counters proving the path went through them;
6. one more PPO iteration under torch.profiler: wall time, device busy
   time and idle share, per-phase host spans, the top kernels by device time;
7. kernel B3 (C51 projection) against its plain version at [8192, 101] ->
   101 (the FastTD3 path's shape), a ragged [8193, 101], [4096, 51] -> 101,
   and positions beyond the support and on atoms;
8. FastTD3 on ``locomotion.ant.cuda`` at full width (1024 envs, batch 8192,
   n_step 3, 101 atoms, 512/256/128 ELU+LayerNorm policy and twin critic,
   f32, the default 1e6-transition buffer) through the entry points: 5
   prefill and 64 learning steps in 4 log lines, with the launch counters
   proving every update went through B3 and every env step through B2;
9. 16 more FastTD3 learning steps under torch.profiler, as phase 6.

Each kernel is timed twice: CUDA events around a run of calls (``ms``: the
wrapper's host cost shows when it exceeds the kernel's) and the profiler's
time of the kernel alone (``device_ms``).  The line before the last is the
kernels' JSON record, the last line the device record.  Needs a CUDA device; never falls back to the CPU.
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
        if o.numel() == 0:
            continue
        if not torch.isfinite(o).all():
            fail(f"{what}: non-finite output")
        diff = (o - r).abs()
        if (diff > atol + rtol * r.abs()).any():
            fail(f"{what}: max |err| {diff.max().item():.3g} beyond rtol={rtol} atol={atol}")
        worst = max(worst, diff.max().item())
    return worst


def kernel_device_ms(fn, reps, kernel_name):
    """Mean device time of the kernel whose name contains ``kernel_name``
    over ``reps`` calls of ``fn``, from torch.profiler's CUDA events: the
    kernel alone, where ``time_ms`` also counts a host that enqueues more
    slowly than the kernel runs.  The tracer may drop an event at the edge
    of the window, so the mean is over the launches it saw (at least half)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel_name in e.name]
    if not reps // 2 <= len(times) <= reps:
        fail(f"profiler saw {len(times)} launches of {kernel_name} in {reps} calls")
    return sum(times) / len(times) / 1e3


def profile_spans(fn, span_prefix):
    """Run ``fn`` once under torch.profiler: wall ms, device busy ms (the sum
    of kernel times; kernels run one at a time on this stream), idle share,
    the host and device time of the ``span_prefix`` record_function spans,
    and the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # A record_function span shows up twice: as a CPU event (host time) and
    # as a GPU annotation (first to last kernel it launched).
    events = prof.events()
    cpu_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    kernel_ms, host_spans_ms, device_spans_ms = {}, {}, {}
    for e in events:
        ms = e.time_range.elapsed_us() / 1e3
        if e.name.startswith(span_prefix):
            spans = host_spans_ms if e.device_type == DeviceType.CPU else device_spans_ms
            spans[e.name] = spans.get(e.name, 0.0) + ms
        elif e.device_type == DeviceType.CUDA and e.name not in cpu_names:
            kernel_ms[e.name] = kernel_ms.get(e.name, 0.0) + ms
    busy_ms = sum(kernel_ms.values())
    top = sorted(kernel_ms.items(), key=lambda kv: -kv[1])[:6]
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms, "host_spans_ms": host_spans_ms,
        "device_spans_ms": device_spans_ms, "top_kernels_ms": {k[:60]: v for k, v in top},
    }


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
            gae = lambda: gae_advantages_cuda(r, v, nv, d, 0.99, 0.95)
            gae_times = (time_ms(gae, 200),
                         time_ms(lambda: gae_advantages_reference(r, v, nv, d, 0.99, 0.95), 20),
                         kernel_device_ms(gae, 200, "gae_kernel"))
    gae_bound = gae_bytes(64, 4096) / H100_BYTES_PER_S * 1e3
    print(f"B1 gae: max|err| {gae_err:.3g} (rtol=atol=1e-5, f32) kernel {gae_times[0]:.4f} ms "
          f"(device {gae_times[2]:.4f} ms) plain {gae_times[1]:.3f} ms bound {gae_bound:.4f} ms "
          f"at [64, 4096]")
    kernels.append(dict(
        name="gae", route="cuda", source="rlx_tpu_torch/csrc/gae.cu",
        replaces="rlx_tpu/ops/gae_pallas.py:53", ms=gae_times[0], device_ms=gae_times[2],
        plain_ms=gae_times[1], bound_ms=gae_bound, bound_by="bytes", library_ms=None,
        max_abs_err=gae_err,
    ))

    # 4. B2: physics substep, at the PPO (4096) and FastTD3 (1024) batch
    # sizes, a ragged batch, and the Ant without contacts / without actuators
    # (the ncon == 0 and nu == 0 branches; the card has no mujoco to compile
    # another model)
    from rlx_tpu_torch.ops.engine_substep_cuda import lanes_per_env, resident_warps_per_sm

    S = 4
    ant = load_model(ANT_MODEL)
    dropped = {
        "no contacts": ("con_body", "con_pos", "con_radius", "con_friction", "con_meff",
                        "con_m_app", "con_m_app_t"),
        "no actuators": ("act_dof", "act_joint_body", "act_kp", "act_kv", "act_gear",
                         "act_is_position", "act_forcerange"),
    }
    variants = {"Ant": ant, **{name: ant._replace(**{f: getattr(ant, f)[:0] for f in fields})
                               for name, fields in dropped.items()}}

    def ant_batch(model, B):
        qpos0 = torch.as_tensor(model.qpos0, device=dev)
        qpos = qpos0.repeat(B, 1) + 0.1 * torch.randn(B, model.nq, device=dev, generator=g)
        qpos[:, 2] = 0.55 + 0.2 * torch.rand(B, device=dev, generator=g)
        qpos[:, 3:7] /= qpos[:, 3:7].norm(dim=1, keepdim=True)
        qvel = 0.5 * torch.randn(B, model.nv, device=dev, generator=g)
        nu = len(model.act_dof)
        ctrl = qpos0[7:7 + nu] + 0.3 * (2.0 * torch.rand(B, nu, device=dev, generator=g) - 1.0)
        return qpos, qvel, ctrl

    def domain_params(model, B):
        u = lambda *shape: 0.8 + 0.4 * torch.rand(*shape, device=dev, generator=g)
        nu = len(model.act_dof)
        return engine.DomainParams(
            mass_scale=u(model.nbody, B), damping_scale=u(B), frictionloss_scale=u(B),
            armature_scale=u(B), friction_scale=u(B), contact_stiffness_scale=u(B),
            kp_scale=u(nu, B), kv_scale=u(nu, B), forcerange_scale=u(nu, B),
            ctrl_offset=0.1 * (u(nu, B) - 1.0),
            gravity=torch.tensor([0.0, 0.0, -9.81], device=dev)[:, None] * u(B),
        )

    cases = (
        ("Ant", 4096, "entry-pose anchors"), ("Ant", 4096, "given anchors"),
        ("Ant", 4096, "all DomainParams"), ("Ant", 1024, "entry-pose anchors"),
        ("Ant", 1024, "all DomainParams"), ("Ant", 1000, "given anchors"),
        ("Ant", 1000, "ctrl_sequence"), ("no contacts", 1000, "all DomainParams"),
        ("no contacts", 1024, "given anchors"), ("no actuators", 1000, "all DomainParams"),
        ("no actuators", 4096, "entry-pose anchors"),
    )
    # f32 on both sides, but the kernel sums in another order and contracts
    # multiply-adds, and the stiff contact penalties amplify those roundings
    # over 4 substeps: 1e-4 relative + absolute.
    rtol = atol = 1e-4
    step_err = 0.0
    for name, B, label in cases:
        model = variants[name]
        qpos, qvel, ctrl = ant_batch(model, B)
        kw = {}
        if label != "entry-pose anchors":
            kw["contact_state"] = engine.contact_anchor_init(model, qpos)
        if label == "all DomainParams":
            kw["dr"] = domain_params(model, B)
        if label == "ctrl_sequence":
            kw["ctrl_sequence"] = ctrl[None] + 0.1 * torch.randn(3, *ctrl.shape, device=dev, generator=g)
        out = step_cuda(model, qpos, qvel, ctrl, nr_substeps=S, **kw)
        ref = engine.step_reference(model, qpos, qvel, ctrl, nr_substeps=S, **kw)
        torch.cuda.synchronize()
        step_err = max(step_err, max_err(out, ref, rtol, atol, f"substep ({name}, B={B}, {label})"))
    print(f"B2 engine_substep: {len(cases)} cases against engine.step_reference, max|err| "
          f"{step_err:.3g} (rtol=atol=1e-4): " + "; ".join(f"{n} B={B} {lab}" for n, B, lab in cases))
    by_batch = {}
    for B in (4096, 1024):
        qpos, qvel, ctrl = ant_batch(ant, B)
        substep = lambda: step_cuda(ant, qpos, qvel, ctrl, nr_substeps=S)
        flops = substep_flops(ant) * B * S
        nbytes = substep_bytes(ant, B, with_anchors=False)
        lanes = lanes_per_env(B)
        t = by_batch[B] = dict(
            ms=time_ms(substep, 100), device_ms=kernel_device_ms(substep, 100, "engine_substep_kernel"),
            plain_ms=time_ms(lambda: engine.step_reference(ant, qpos, qvel, ctrl, nr_substeps=S), 3),
            bound_ms=max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS) * 1e3,
            bound_by="bytes" if nbytes / H100_BYTES_PER_S > flops / H100_F32_FLOPS else "operations",
            lanes_per_env=lanes, resident_warps_per_sm=resident_warps_per_sm(ant, lanes),
        )
        print(f"B2 engine_substep at B={B}, {S} substeps: kernel {t['ms']:.4f} ms (device "
              f"{t['device_ms']:.4f} ms) plain {t['plain_ms']:.2f} ms bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}: {flops} flops, {nbytes} bytes), {100 * t['bound_ms'] / t['device_ms']:.2f} % "
              f"of the bound; {lanes} lanes per env, {t['resident_warps_per_sm']} resident warps per SM")
    main = by_batch[4096]
    kernels.append(dict(
        name="engine_substep", route="cuda", source="rlx_tpu_torch/csrc/engine_substep.cu",
        replaces="rlx_tpu/ops/engine_substep_pallas.py:82", ms=main["ms"], device_ms=main["device_ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=None, max_abs_err=step_err, by_batch={str(B): t for B, t in by_batch.items()},
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
    def one_iteration():
        model.env_state, _ = model.learning_iteration(model.env_state)

    print("profile: " + json.dumps(profile_spans(one_iteration, "ppo/")))
    launches_by_path = {"ppo": launches}

    # 7. B3: C51 projection
    from rlx_tpu_torch.ops.distributional import categorical_projection_reference
    from rlx_tpu_torch.ops.projection_cuda import (
        categorical_projection_cuda, projection_bytes, projection_flops,
    )

    v_min, v_max, nr_atoms = -10.0, 10.0, 101
    atoms = torch.linspace(v_min, v_max, nr_atoms, device=dev)

    def softmax_probs(n, a):
        return torch.softmax(2.0 * torch.randn(n, a, device=dev, generator=g), dim=-1)

    def fasttd3_targets(n):
        # r + gamma_n (1 - d) atoms, as the FastTD3 update builds them
        r = 3.0 * torch.randn(n, 1, device=dev, generator=g)
        d = (torch.rand(n, 1, device=dev, generator=g) < 0.1).float()
        gamma_n = 0.97 ** torch.randint(1, 4, (n, 1), device=dev, generator=g).float()
        return r + gamma_n * (1.0 - d) * atoms[None]

    on_atoms = atoms[None].repeat(8192, 1)   # every position an atom (b integral or 1 ulp off)
    on_atoms[4096:] = torch.where(torch.rand(4096, nr_atoms, device=dev, generator=g) < 0.5,
                                  v_min - 2.0, v_max + 2.0)
    cases = {
        "[8192, 101] FastTD3 targets": (fasttd3_targets(8192), softmax_probs(8192, 101)),
        "[8193, 101] ragged": (28.0 * torch.rand(8193, 101, device=dev, generator=g) - 14.0,
                               softmax_probs(8193, 101)),
        "[4096, 51] -> 101": (28.0 * torch.rand(4096, 51, device=dev, generator=g) - 14.0,
                              softmax_probs(4096, 51)),
        "[8192, 101] on atoms and beyond the support": (on_atoms, softmax_probs(8192, 101)),
    }
    # f32 on both sides with the same true division; the kernel sums over j
    # in order with fused multiply-adds, the plain einsum in its own order
    rtol = atol = 1e-6
    proj_err = 0.0
    for label, (z, p) in cases.items():
        out = categorical_projection_cuda(z, p, v_min, v_max, nr_atoms)
        ref = categorical_projection_reference(z, p, v_min, v_max, nr_atoms)
        torch.cuda.synchronize()
        proj_err = max(proj_err, max_err([out], [ref], rtol, atol, f"projection {label}"))
    z, p = cases["[8192, 101] FastTD3 targets"]
    project = lambda: categorical_projection_cuda(z, p, v_min, v_max, nr_atoms)
    proj_ms = time_ms(project, 200)
    proj_device_ms = kernel_device_ms(project, 200, "projection_kernel")
    proj_plain_ms = time_ms(lambda: categorical_projection_reference(z, p, v_min, v_max, nr_atoms), 20)
    nbytes, flops = projection_bytes(8192, 101, 101), projection_flops(8192, 101)
    proj_bound = max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS) * 1e3
    bound_by = "bytes" if nbytes / H100_BYTES_PER_S > flops / H100_F32_FLOPS else "operations"
    print(f"B3 projection: max|err| {proj_err:.3g} (rtol=atol=1e-6, f32) kernel {proj_ms:.4f} ms "
          f"(device {proj_device_ms:.4f} ms) plain {proj_plain_ms:.3f} ms bound {proj_bound:.5f} ms "
          f"({bound_by}: {nbytes} bytes, {flops} flops) at [8192, 101] -> 101")
    kernels.append(dict(
        name="categorical_projection", route="cuda", source="rlx_tpu_torch/csrc/projection.cu",
        replaces="rlx_tpu/ops/projection_pallas.py:47", ms=proj_ms, device_ms=proj_device_ms,
        plain_ms=proj_plain_ms,
        bound_ms=proj_bound, bound_by=bound_by, library_ms=None, max_abs_err=proj_err,
    ))

    # 8. FastTD3 through the entry points
    nr_envs, learning_steps, log_steps = 1024, 64, 16
    learning_starts = 5000
    config = make_config("fasttd3.cuda", "locomotion.ant.cuda", **{
        "runner.device": "cuda",
        "environment.nr_envs": nr_envs,
        "algorithm.batch_size": 8192,
        "algorithm.n_step": 3,
        "algorithm.nr_atoms": nr_atoms,
        "algorithm.v_min": v_min,
        "algorithm.v_max": v_max,
        "algorithm.learning_starts": learning_starts,
        "algorithm.total_timesteps": learning_starts + learning_steps * nr_envs,
        "algorithm.logging_frequency": log_steps * nr_envs,
        "algorithm.evaluation_active": False,
    })
    td3 = create_model(config)
    step_cuda.launches = 0
    categorical_projection_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    td3.train()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    td3_launches = {"engine_substep": step_cuda.launches,
                    "categorical_projection": categorical_projection_cuda.launches}
    expected = {"engine_substep": td3.prefill_iterations + learning_steps,
                "categorical_projection": learning_steps}
    if td3.prefill_iterations != 5 or td3_launches != expected:
        fail(f"FastTD3 launch counts {td3_launches} != {expected} (prefill {td3.prefill_iterations})")
    history = td3.metrics_history
    if [m["steps/nr_updates"] for m in history] != [16, 32, 48, 64]:
        fail(f"FastTD3 logged {[m['steps/nr_updates'] for m in history]}, expected [16, 32, 48, 64]")
    for it, metrics in enumerate(history):
        for k, v in metrics.items():
            if not math.isfinite(v):
                fail(f"FastTD3 log line {it}: {k} = {v}")
    for state in (td3.policy, td3.critic):
        for module in (state.module, state.target):
            if not all(torch.isfinite(p).all() for p in module.parameters()):
                fail("FastTD3: non-finite parameters after training")
    count = float(td3.obs_normalizer["count"])
    finite = all(torch.isfinite(v).all() for v in td3.obs_normalizer.values())
    if count < learning_steps * nr_envs or not finite:
        fail(f"FastTD3 observation normalizer count {count} < {learning_steps * nr_envs} or not finite")
    env_steps = (td3.prefill_iterations + learning_steps) * nr_envs
    print(f"train: FastTD3 {td3.prefill_iterations} prefill + {learning_steps} learning steps at "
          f"{nr_envs} envs, batch 8192, in {elapsed:.2f} s ({env_steps / elapsed:.0f} env-steps/s, "
          f"buffer allocation and prefill included); env-steps/s of the 4 log lines (the first "
          f"includes the prefill) {[m['time/sps'] for m in history]}, launches {td3_launches}, "
          f"normalizer count {count}, "
          f"buffer {td3.buffer.storage.numel() * 4 / 2**20:.0f} MiB, last log line "
          + json.dumps({k: v for k, v in history[-1].items() if k.startswith(("loss/", "q_value/"))}))
    launches_by_path["fasttd3"] = td3_launches

    # 9. where the time goes: 16 more learning steps under the profiler
    def one_logging_iteration():
        td3.env_state = td3._logging_iteration(td3.buffer, td3.env_state, learning_steps)

    print("profile fasttd3: " + json.dumps(profile_spans(one_logging_iteration, "fasttd3/")))

    for k in kernels:
        by_path = {path: counts[k["name"]]
                   for path, counts in launches_by_path.items() if k["name"] in counts}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
