"""The dp mesh on a card: one rank of ``chip_smoke.py``'s phase 46, or the
one-rank NCCL check.

    python -m rlx_tpu_torch.benchmarks.mesh_phase --rank 0 --world 2 --init /tmp/rdv --out /tmp/mesh
    python -m rlx_tpu_torch.benchmarks.mesh_phase --nccl-one-rank --init /tmp/rdv1 --out /tmp/mesh

With ``--world 2`` each rank joins a gloo group (two ranks may share one
card: NCCL refuses two ranks on one device; gloo runs ``all_reduce`` and
``broadcast`` on CUDA tensors) and runs, on ``cuda:{LOCAL_RANK % cards}``:

1. PPO on ``locomotion.ant.cuda`` at dp = 2 (``nr_envs`` envs, half a rank,
   shard-local minibatching off, f32 512/256/128 ELU+LayerNorm nets) for
   one iteration, recording the first minibatch's gradients as PPO's own
   ``_clip_gradients`` leaves them (averaged over dp, clipped); rank 0
   then runs the same iteration at dp = 1 (no collectives) and reports
   the gradients' error relative to their largest and the parameters'
   largest error after the iteration (``chip_smoke.py`` holds both);
2. the all_reduce of the policy's and the critic's gradients, timed;
3. SAC and FastTD3 at dp = 2 on the Ant (1 prefill, a few learning steps,
   shard-local sampling), every parameter finite and equal on both ranks.

Each rank counts its own kernel launches (B1, B2, B3: the wrappers'
counters) and writes ``rank<r>.json`` under ``--out``.  ``--nccl-one-rank``
makes a one-rank NCCL group, runs one PPO iteration in it, sends its
gradients through NCCL's ``all_reduce`` and ``broadcast`` on the card
(each must give them back bit for bit) and runs the iteration again with
no group, which must agree bit for bit (``nccl.json``).  NCCL's dp > 1
path needs a card a rank: ``--torchrun`` below.

Under torchrun (``--torchrun``: the group from torchrun's environment,
NCCL on cards, one card a rank) the same runs over every rank, and
``--weak`` adds PPO at ``nr_envs`` envs a rank (weak scaling) against
rank 0's dp = 1 iteration at ``nr_envs``:

    torchrun --nproc-per-node=4 -m rlx_tpu_torch.benchmarks.mesh_phase --torchrun --weak --out out
"""

import argparse
import datetime
import json
import os
import time

import torch
import torch.distributed as dist

from rlx_tpu_torch.parallel import mesh as mesh_lib

PPO_NETS = {"algorithm.policy_hidden_sizes": (512, 256, 128), "algorithm.critic_hidden_sizes": (512, 256, 128),
            "algorithm.activation": "elu", "algorithm.layer_norm": True, "algorithm.entropy_coef": 0.01}


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def counts():
    from rlx_tpu_torch.ops.engine_substep_cuda import step_cuda
    from rlx_tpu_torch.ops.gae_cuda import gae_advantages_cuda
    from rlx_tpu_torch.ops.projection_cuda import categorical_projection_cuda

    return {"engine_substep": step_cuda.launches, "gae": gae_advantages_cuda.launches,
            "categorical_projection": categorical_projection_cuda.launches}


def zero_counts():
    from rlx_tpu_torch.ops.engine_substep_cuda import step_cuda
    from rlx_tpu_torch.ops.gae_cuda import gae_advantages_cuda
    from rlx_tpu_torch.ops.projection_cuda import categorical_projection_cuda

    sync()
    step_cuda.launches = gae_advantages_cuda.launches = categorical_projection_cuda.launches = 0


def ppo_model(dp, nr_envs, nr_steps, device="cuda"):
    from rlx_tpu_torch.config import create_model, make_config

    return create_model(make_config("ppo.cuda", "locomotion.ant.cuda", **{
        **PPO_NETS, "runner.device": device, "environment.nr_envs": nr_envs, "algorithm.nr_steps": nr_steps,
        "algorithm.minibatch_size": nr_envs * nr_steps // 8, "algorithm.nr_epochs": 1,
        "algorithm.total_timesteps": nr_envs * nr_steps, "algorithm.evaluation_active": False,
        "algorithm.logging_active": False, "algorithm.shard_local_minibatching": False,
        "runner.mesh_dp": dp, "runner.mesh_tp": 1}))


def record_first_gradients(model):
    """Keep a copy of the first minibatch's gradients in
    ``model.first_gradients`` as the optimizer takes them: after PPO's own
    ``_clip_gradients`` (averaged over dp, then clipped by the global norm,
    the same function at every dp), and the norms it measured before the
    clip in ``model.first_grad_norms``."""
    clip = model._clip_gradients

    def recording(metrics):
        clip(metrics)
        if not hasattr(model, "first_gradients"):
            model.first_gradients = [p.grad.detach().clone() for p in list(model.policy.module.parameters())
                                     + list(model.critic.parameters())]
            # the norms before the clip: a sum over dp in place of a mean would double them
            model.first_grad_norms = [float(metrics[f"gradients/{name}_grad_norm"]) for name in ("policy", "critic")]

    model._clip_gradients = recording


def one_iteration(model):
    """One PPO learning iteration from a fresh reset; (seconds, launches)."""
    zero_counts()
    state = model.train_env.reset(model.seed)
    sync()
    t0 = time.perf_counter()
    model.learning_iteration(state)
    sync()
    return time.perf_counter() - t0, counts()


def parameters(model):
    return [p.detach().double() for p in list(model.policy.module.parameters()) + list(model.critic.parameters())]


def replicated_error(modules, mesh):
    """The largest |parameter - dp rank 0's| over ``modules``."""
    worst = 0.0
    for module in modules:
        for p in module.parameters():
            x = p.detach().double()
            ref = x.clone() if mesh.dp_rank == 0 else torch.zeros_like(x)
            ref = mesh.all_reduce_sum(ref)
            if not torch.isfinite(x).all():
                raise RuntimeError("a parameter is not finite")
            worst = max(worst, (x - ref).abs().max().item())
    return worst


def run_rank(rank, world, out, nr_envs, nr_steps, device="cuda", weak=False):
    from rlx_tpu_torch.config import create_model, make_config

    record = {"rank": rank, "device": torch.cuda.get_device_name(0) if device == "cuda" else device}
    # 1. PPO at dp = 2 (warm-up iteration first: the kernels' first calls)
    model = ppo_model(world, nr_envs, nr_steps, device)
    one_iteration(model)
    model = ppo_model(world, nr_envs, nr_steps, device)
    record_first_gradients(model)
    seconds, launches = one_iteration(model)
    record["ppo"] = {"rank_envs": model.train_env.nr_envs, "iteration_s": seconds, "launches": launches,
                     "env_steps_per_s": nr_envs * nr_steps / seconds,
                     "replicated_err": replicated_error((model.policy.module, model.critic), model.mesh)}
    grads_dp, norms_dp, params_dp = model.first_gradients, model.first_grad_norms, parameters(model)

    # 2. the gradients' all_reduce over the group
    grads = [p.detach().clone() for p in list(model.policy.module.parameters()) + list(model.critic.parameters())]
    model.mesh.all_reduce_mean_(grads)
    sync()
    t0 = time.perf_counter()
    for _ in range(20):
        model.mesh.all_reduce_mean_(grads)
    sync()
    record["all_reduce_ms"] = (time.perf_counter() - t0) / 20 * 1e3
    record["all_reduce_mib"] = sum(g.numel() for g in grads) * 4 / 2 ** 20

    # 3. SAC and FastTD3 at dp = 2, shard-local sampling
    off_envs = min(1024, nr_envs)
    for name, overrides in (("sac", {}), ("fasttd3", {"algorithm.n_step": 3})):
        algorithm = create_model(make_config(f"{name}.cuda", "locomotion.ant.cuda", **{
            "runner.device": device, "environment.nr_envs": off_envs, "algorithm.batch_size": 8 * off_envs,
            "algorithm.learning_starts": off_envs, "algorithm.total_timesteps": off_envs * 5,
            "algorithm.buffer_size": off_envs * 64, "algorithm.logging_frequency": off_envs * 4,
            "algorithm.evaluation_active": False,
            "algorithm.logging_active": False, "runner.mesh_dp": world, **overrides}))
        zero_counts()
        sync()
        t0 = time.perf_counter()
        algorithm.train()
        sync()
        states = [getattr(algorithm, n).module for n in algorithm.state_names if hasattr(getattr(algorithm, n), "module")]
        record[name] = {"train_s": time.perf_counter() - t0, "launches": counts(),
                        "replicated_err": replicated_error(states, algorithm.mesh),
                        "rank_envs": algorithm.train_env.nr_envs, "rank_batch": algorithm.batch_size // world}

    # weak scaling: nr_envs a rank
    if weak:
        scaled = ppo_model(world, nr_envs * world, nr_steps, device)
        one_iteration(scaled)
        seconds, launches = one_iteration(scaled)
        record["ppo_weak"] = {"rank_envs": scaled.train_env.nr_envs, "iteration_s": seconds, "launches": launches,
                              "env_steps_per_s": nr_envs * world * nr_steps / seconds}
        del scaled

    # rank 0: the same PPO iteration at dp = 1 (the other ranks wait below)
    if rank == 0:
        reference = ppo_model(1, nr_envs, nr_steps, device)
        record_first_gradients(reference)
        seconds, launches = one_iteration(reference)
        largest = max(g.double().abs().max().item() for g in reference.first_gradients)
        grad_err = max((a.double() - b.double()).abs().max().item()
                       for a, b in zip(grads_dp, reference.first_gradients)) / largest
        norm_err = max(abs(a - b) / b for a, b in zip(norms_dp, reference.first_grad_norms))
        param_err = max((a - b).abs().max().item() for a, b in zip(params_dp, parameters(reference)))
        record["ppo_dp1"] = {"iteration_s": seconds, "launches": launches,
                             "env_steps_per_s": nr_envs * nr_steps / seconds,
                             "first_gradient_rel_err": grad_err, "first_grad_norm_rel_err": norm_err,
                             "first_grad_norms": reference.first_grad_norms,
                             "param_err_after_iteration": param_err, "largest_gradient": largest}
    model.mesh.all_reduce_sum(torch.zeros(1, device=model.device))   # every rank done
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)


def run_nccl_one_rank(out, nr_envs, nr_steps):
    """In a one-rank NCCL group: one PPO iteration, then its gradients
    through NCCL's ``all_reduce`` (a sum) and ``broadcast`` from rank 0 on
    the card, both timed after a first all_reduce that sets NCCL up; then
    the iteration again with no group.  A mesh of one rank makes no
    collective of its own (``make_mesh`` gives the one-device mesh), so
    the collectives are called here directly."""
    results = []
    for with_group in (True, False):
        torch.manual_seed(0)
        model = ppo_model(-1, nr_envs, nr_steps)
        seconds, launches = one_iteration(model)
        results.append((parameters(model), seconds, launches))
        if with_group:
            grads = torch.cat([p.grad.detach().reshape(-1) for p in list(model.policy.module.parameters())
                               + list(model.critic.parameters())])
            reduced, broadcast = grads.clone(), grads.clone()
            sync()
            t_first = time.perf_counter()
            dist.all_reduce(grads.clone())   # the first collective sets NCCL's communicator up
            sync()
            t0 = time.perf_counter()
            dist.all_reduce(reduced)
            sync()
            t1 = time.perf_counter()
            dist.broadcast(broadcast, src=0)
            sync()
            t2 = time.perf_counter()
            record = {"backend": dist.get_backend(), "world": dist.get_world_size(), "mesh": repr(model.mesh),
                      "collective_device": str(grads.device), "collective_mib": grads.numel() * 4 / 2 ** 20,
                      "all_reduce_equal": torch.equal(reduced, grads), "broadcast_equal": torch.equal(broadcast, grads),
                      "first_all_reduce_ms": (t0 - t_first) * 1e3, "all_reduce_ms": (t1 - t0) * 1e3,
                      "broadcast_ms": (t2 - t1) * 1e3}
            dist.destroy_process_group()
    equal = all(torch.equal(a, b) for a, b in zip(results[0][0], results[1][0]))
    record.update(bit_for_bit=equal, launches=results[0][2], no_group_launches=results[1][2],
                  iteration_s=results[0][1], no_group_iteration_s=results[1][1])
    with open(os.path.join(out, "nccl.json"), "w") as f:
        json.dump(record, f)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--init", default="", help="a file:// rendezvous path (without --torchrun)")
    parser.add_argument("--out", required=True)
    parser.add_argument("--nr-envs", type=int, default=4096)
    parser.add_argument("--nr-steps", type=int, default=16)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--nccl-one-rank", action="store_true")
    parser.add_argument("--torchrun", action="store_true", help="the group from torchrun's environment")
    parser.add_argument("--weak", action="store_true", help="add PPO at nr_envs envs a rank")
    args = parser.parse_args(argv)
    if args.torchrun:
        os.makedirs(args.out, exist_ok=True)
        world = mesh_lib.initialize_distributed(timeout=datetime.timedelta(seconds=600))
        try:
            run_rank(mesh_lib.rank(), world, args.out, args.nr_envs, args.nr_steps, args.device, args.weak)
        finally:
            dist.destroy_process_group()
        return
    if args.nccl_one_rank:
        os.environ.update(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
        dist.init_process_group("nccl", init_method=f"file://{args.init}", world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=300))
        run_nccl_one_rank(args.out, args.nr_envs, args.nr_steps)
        return
    os.environ.update(WORLD_SIZE=str(args.world), RANK=str(args.rank), LOCAL_RANK=str(args.rank))
    mesh_lib.initialize_distributed(f"file://{args.init}", backend="gloo", timeout=datetime.timedelta(seconds=300))
    try:
        run_rank(args.rank, args.world, args.out, args.nr_envs, args.nr_steps, args.device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
