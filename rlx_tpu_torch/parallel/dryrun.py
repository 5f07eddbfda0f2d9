"""A dry run of the port's mesh over n processes: the counterpart of the
JAX package's ``__graft_entry__.py::dryrun_multichip``.

    torchrun --nproc-per-node=N -m rlx_tpu_torch.parallel.dryrun            # N cards
    python -m rlx_tpu_torch.parallel.dryrun --spawn 4 --device cpu          # 4 gloo ranks on the CPU

Each rank runs, on the mesh of every rank:

1. one PPO iteration at dp x tp (tp = 2 where n is even: the nets split
   column / row over tp, the env batch over dp, shard-local minibatching);
2. one SAC run with the replay sharded over dp (a prefill and learning
   steps, shard-local sampling);
3. one PPO-LSTM iteration (the carry over the env rows, env minibatches).

Each checks that every parameter is finite and equal on every dp rank
(the sum of a parameter over dp is dp times rank 0's), and prints a line
on rank 0.  ``--spawn N`` starts N ranks with a ``file://`` rendezvous
and gloo (two ranks may share one card: NCCL refuses that); under
torchrun the group is NCCL on cards, gloo on the CPU.
"""

import argparse
import datetime
import os
import subprocess
import sys
import tempfile

import torch

from rlx_tpu_torch.parallel import mesh as mesh_lib


def _check_replicated(modules, mesh, what):
    """Every parameter finite and the same on every dp rank."""
    for module in modules:
        for name, p in module.named_parameters():
            x = p.detach().double()
            assert torch.isfinite(x).all(), f"{what}: {name} is not finite"
            total = mesh.all_reduce_sum(x)
            assert torch.allclose(total, x * mesh.dp, rtol=1e-6, atol=1e-9), f"{what}: {name} differs over dp"


def dryrun_multichip(n, device="cuda"):
    """The three programs over the ``n`` ranks of the current process group."""
    from rlx_tpu_torch.config import create_model, make_config

    assert mesh_lib.world_size() == n, f"need a group of {n} processes, have {mesh_lib.world_size()}"
    tp = 2 if n % 2 == 0 else 1
    dp = n // tp
    main = mesh_lib.rank() == 0

    # 1. PPO on dp x tp
    nr_envs, nr_steps = max(dp * 4, 8), 8
    model = create_model(make_config("ppo.cuda", "classic.pendulum.cuda", **{
        "runner.device": device, "environment.nr_envs": nr_envs, "algorithm.total_timesteps": nr_envs * nr_steps,
        "algorithm.nr_steps": nr_steps, "algorithm.minibatch_size": nr_envs * nr_steps // 4,
        "algorithm.nr_epochs": 1, "algorithm.evaluation_active": False, "algorithm.logging_active": False,
        "algorithm.policy_hidden_sizes": (256, 256), "algorithm.critic_hidden_sizes": (256, 256),
        "runner.mesh_dp": dp, "runner.mesh_tp": tp}))
    assert model.mesh.shape == {"dp": dp, "tp": tp}
    model.train()
    _check_replicated((model.policy.module, model.critic), model.mesh, "ppo")
    if main:
        print(f"dryrun_multichip PPO OK: mesh dp={dp} tp={tp}, nr_envs={nr_envs}", flush=True)

    # 2. SAC with a sharded replay, shard-local sampling
    model = create_model(make_config("sac.cuda", "classic.pendulum.cuda", **{
        "runner.device": device, "environment.nr_envs": 2 * n, "algorithm.total_timesteps": 2 * n * 24,
        "algorithm.learning_starts": 2 * n * 8, "algorithm.batch_size": 16 * n,
        "algorithm.buffer_size": 2 * n * 64, "algorithm.evaluation_active": False,
        "algorithm.logging_active": False, "runner.mesh_dp": n}))
    model.train()
    _check_replicated((model.policy.module, model.critic.module), model.mesh, "sac")
    if main:
        print(f"dryrun_multichip SAC OK: dp={n}, replay {model.buffer.nr_envs} of {2 * n} envs a rank",
              flush=True)

    # 3. PPO-LSTM: the carry over the env rows, env minibatches
    model = create_model(make_config("ppo_lstm.cuda", "classic.pendulum.cuda", **{
        "runner.device": device, "environment.mask_velocity": True, "environment.nr_envs": 4 * n,
        "algorithm.nr_steps": 16, "algorithm.total_timesteps": 4 * n * 16, "algorithm.nr_minibatches": 2,
        "algorithm.nr_epochs": 1, "algorithm.evaluation_active": False, "algorithm.logging_active": False,
        "runner.mesh_dp": n}))
    model.train()
    _check_replicated((model.policy, model.critic), model.mesh, "ppo_lstm")
    if main:
        print(f"dryrun_multichip PPO-LSTM OK: dp={n}", flush=True)


def _spawn(n, device, limit=600):
    """Run the dry run in ``n`` local gloo ranks; returns the
    exit codes."""
    with tempfile.TemporaryDirectory() as directory:
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        procs = [subprocess.Popen([sys.executable, "-m", "rlx_tpu_torch.parallel.dryrun", "--device", device,
                                   "--rank", str(r), "--world", str(n), "--init", os.path.join(directory, "rdv")],
                                  env=env) for r in range(n)]
        try:
            return [p.wait(timeout=limit) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--spawn", type=int, default=0, help="start this many local gloo ranks")
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--world", type=int, default=None)
    parser.add_argument("--init", default="", help="a file:// rendezvous path (with --rank / --world)")
    args = parser.parse_args(argv)
    if args.spawn:
        codes = _spawn(args.spawn, args.device)
        sys.exit(max(abs(c) for c in codes))
    if args.rank is not None:
        os.environ.update(WORLD_SIZE=str(args.world), RANK=str(args.rank), LOCAL_RANK=str(args.rank))
        mesh_lib.initialize_distributed(f"file://{args.init}", backend="gloo",
                                        timeout=datetime.timedelta(seconds=120))
    else:
        mesh_lib.initialize_distributed()
    try:
        dryrun_multichip(mesh_lib.world_size(), args.device)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
