"""One rank of the port's mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_partition.py``): started as a child process by
``torch_mesh_spawn.spawn``, it joins a gloo group over a ``file://``
rendezvous, runs one suite of cases and writes each case's result under
``--out`` (``<case>.<tag>.pt``).  It imports torch and the port only, never
JAX: the JAX side of a comparison runs in the parent.

    python tests/torch_mesh_worker.py --suite families --rank 0 --world 2 \
        --init /tmp/rdv --out /tmp/results
"""

import argparse
import datetime
import os
import sys
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from rlx_tpu_torch.config import create_model, make_config  # noqa: E402
from rlx_tpu_torch.ops import replay_buffer as rb  # noqa: E402
from rlx_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402

SMALL_NETS = {"algorithm.policy_hidden_sizes": (16, 16), "algorithm.critic_hidden_sizes": (16, 16)}
SCALED_NETS = {"algorithm.policy_hidden_dim": 8, "algorithm.critic_hidden_dim": 16, "algorithm.policy_nr_blocks": 1,
               "algorithm.critic_nr_blocks": 1}
# one iteration of 4 envs x 8 steps, then an eval (horizon 8)
ON_POLICY = {"environment.nr_envs": 4, "algorithm.nr_steps": 8, "algorithm.total_timesteps": 32,
             "algorithm.evaluation_and_save_frequency": 32, "environment.horizon": 8}
PPO = {**ON_POLICY, **SMALL_NETS, "algorithm.minibatch_size": 8, "algorithm.nr_epochs": 2,
       "algorithm.shard_local_minibatching": False}
RECURRENT = {**ON_POLICY, "environment.mask_velocity": True, "algorithm.nr_minibatches": 2,
             "algorithm.nr_epochs": 2, "algorithm.obs_encoding_dim": 16, "algorithm.rnn_hidden_dim": 16}
# a prefill of 8 steps (2 a env), 8 learning steps, an eval after them
OFF_POLICY = {"environment.nr_envs": 4, "algorithm.total_timesteps": 40, "algorithm.learning_starts": 8,
              "algorithm.batch_size": 8, "algorithm.logging_frequency": 16, "algorithm.buffer_size": 64,
              "algorithm.evaluation_and_save_frequency": 32, "environment.horizon": 8,
              "algorithm.shard_local_sampling": False}
PENDULUM, CARTPOLE, ANT = "classic.pendulum.cuda", "classic.cart_pole.cuda", "locomotion.ant.cuda"
# every family at a tiny size: (algorithm, environment, overrides)
FAMILIES = {
    "ppo": ("ppo", PENDULUM, PPO),
    "ppo_ant": ("ppo", ANT, {**PPO, "algorithm.activation": "elu", "algorithm.layer_norm": True,
                             "algorithm.nr_steps": 4, "algorithm.total_timesteps": 16,
                             "algorithm.evaluation_and_save_frequency": 16, "environment.horizon": 4}),
    "ppo_discrete": ("ppo", CARTPOLE, PPO),
    "ppo_history_window": ("ppo_history_window", PENDULUM, {**PPO, "environment.mask_velocity": True}),
    "ppo_memory_actions": ("ppo_memory_actions", PENDULUM, {**PPO, "environment.mask_velocity": True}),
    "espo": ("espo", PENDULUM, {**ON_POLICY, **SMALL_NETS, "algorithm.nr_epochs": 4, "algorithm.max_ratio_delta": 0.02,
                                "algorithm.learning_rate": 3e-3, "algorithm.minibatch_size": 16,
                                "algorithm.delta_calc_operator": "median"}),
    "ppo_dtrl": ("ppo_dtrl", PENDULUM, PPO),
    "ppo_lstm": ("ppo_lstm", PENDULUM, RECURRENT),
    "ppo_gru": ("ppo_gru", PENDULUM, RECURRENT),
    "ppo_mamba2": ("ppo_mamba2", PENDULUM, RECURRENT),
    "ppo_transformer": ("ppo_transformer", PENDULUM, RECURRENT),
    "reppo": ("reppo", PENDULUM, {**ON_POLICY, "algorithm.policy_hidden_dim": 16, "algorithm.critic_hidden_dim": 16,
                                  "algorithm.nr_minibatches": 2, "algorithm.nr_epochs": 2}),
    "pqn": ("pqn", CARTPOLE, {**ON_POLICY, "algorithm.critic_hidden_sizes": (16, 16), "algorithm.nr_minibatches": 2,
                              "algorithm.nr_epochs": 2}),
    "sac": ("sac", PENDULUM, {**OFF_POLICY, **SMALL_NETS}),
    "simba": ("simba", PENDULUM, {**OFF_POLICY, "algorithm.policy_hidden_dim": 16, "algorithm.critic_hidden_dim": 16}),
    "td3": ("td3", PENDULUM, {**OFF_POLICY, **SMALL_NETS, "algorithm.policy_delay": 2}),
    "ddpg": ("ddpg", PENDULUM, {**OFF_POLICY, **SMALL_NETS}),
    "fasttd3": ("fasttd3", PENDULUM, {**OFF_POLICY, **SMALL_NETS, "algorithm.n_step": 3, "algorithm.nr_atoms": 11}),
    "dqn": ("dqn", CARTPOLE, {**OFF_POLICY, "algorithm.critic_hidden_sizes": (16, 16)}),
    "ddqn": ("ddqn", CARTPOLE, {**OFF_POLICY, "algorithm.critic_hidden_sizes": (16, 16)}),
    "c51": ("c51", CARTPOLE, {**OFF_POLICY, "algorithm.critic_hidden_sizes": (16, 16), "algorithm.nr_atoms": 11}),
    "dqn_hl_gauss": ("dqn_hl_gauss", CARTPOLE, {**OFF_POLICY, "algorithm.critic_hidden_sizes": (16, 16),
                                                "algorithm.nr_atoms": 11}),
    "fastsac": ("fastsac", PENDULUM, {**OFF_POLICY, **SMALL_NETS, "algorithm.n_step": 3, "algorithm.nr_atoms": 11}),
    "flashsac": ("flashsac", PENDULUM, {**OFF_POLICY, **SCALED_NETS, "algorithm.nr_atoms": 11}),
    "crossq": ("crossq", PENDULUM, {**OFF_POLICY, **SMALL_NETS, "algorithm.policy_delay": 2}),
    "tqc": ("tqc", PENDULUM, {**OFF_POLICY, **SMALL_NETS, "algorithm.nr_atoms_per_net": 5,
                              "algorithm.nr_dropped_atoms_per_net": 1}),
    "xqc": ("xqc", PENDULUM, {**OFF_POLICY, **SCALED_NETS, "algorithm.nr_atoms": 11, "algorithm.policy_delay": 2}),
    "simbav2": ("simbav2", PENDULUM, {**OFF_POLICY, **SCALED_NETS, "algorithm.nr_atoms": 11}),
    "redq": ("redq", PENDULUM, {**OFF_POLICY, **SMALL_NETS, "algorithm.nr_critics": 4, "algorithm.q_update_steps": 2}),
    "droq": ("droq", PENDULUM, {**OFF_POLICY, **SMALL_NETS, "algorithm.dropout_rate": 0.2,
                                "algorithm.q_update_steps": 2}),
    "aqe": ("aqe", PENDULUM, {**OFF_POLICY, **SMALL_NETS, "algorithm.nr_critics": 4,
                              "algorithm.nr_dropped_q_values": 1, "algorithm.q_update_steps": 2}),
    # a reset inside the run: at learning step 4
    "bro": ("bro", PENDULUM, {**OFF_POLICY, **SCALED_NETS, "algorithm.nr_quantiles": 5,
                              "algorithm.updates_per_step": 2, "algorithm.first_reset_step": 4,
                              "algorithm.reset_interval": 12}),
    "mpo": ("mpo", PENDULUM, {**OFF_POLICY, **SMALL_NETS, "algorithm.nr_atoms": 11,
                              "algorithm.action_sampling_number": 3, "algorithm.target_network_update_period": 2}),
    "fastmpo": ("fastmpo", PENDULUM, {**{k: v for k, v in OFF_POLICY.items() if k != "algorithm.buffer_size"},
                                      **SMALL_NETS, "algorithm.nr_atoms": 11, "algorithm.action_sampling_number": 3,
                                      "algorithm.critic_network_type": "mpo", "algorithm.policy_network_type": "mpo",
                                      "algorithm.learning_starts_per_env": 2, "algorithm.buffer_size_per_env": 32,
                                      "algorithm.nr_critic_updates_per_policy_update": 2,
                                      "algorithm.nr_policy_updates_per_step": 2,
                                      "algorithm.evaluation_active": True}),
    # PPO on the native host Pendulum: each rank steps its own rows
    "ppo_host": ("ppo", "native.pendulum.host", {**PPO, "environment.nr_threads": 1}),
}


def family_config(case, dp):
    """The case's config; keys its family lacks are left out (the PPO
    variants read ``shard_local_minibatching`` with JAX's default,
    ``trained_state`` turns it off on the model)."""
    algorithm, environment, overrides = FAMILIES[case]
    keys = make_config(f"{algorithm}.cuda", environment)
    overrides = {k: v for k, v in overrides.items() if k.split(".", 1)[1] in keys[k.split(".", 1)[0]]}
    return make_config(f"{algorithm}.cuda", environment, **{
        **overrides, "runner.device": "cpu", "environment.seed": 5, "algorithm.logging_active": False,
        "runner.mesh_dp": dp, "runner.mesh_tp": 1})


def state_of(model):
    """A trained model's parameters (its checkpoint tree) and eval history."""
    history = {k: torch.as_tensor(v) for k, v in (model.eval_history or {}).items()}
    return {"tree": model.checkpoint_tree(), "eval_history": history}


# cases that run in float32: the Ant's model tables and the host batcher are float32
FLOAT32 = {"ppo_ant", "ppo_host"}


def trained_state(case, dp):
    """The case trained at ``dp`` in float64 (float32 for ``FLOAT32``)."""
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32 if case in FLOAT32 else torch.float64)
    try:
        model = create_model(family_config(case, dp))
        if hasattr(model, "shard_local_minibatching"):
            model.shard_local_minibatching = False   # the PPO variants' configs have no such key
        model.train()
        state = state_of(model)
        model.train_env.close()
    finally:
        torch.set_default_dtype(default)
    return state


def run_families(rank, world, out, cases):
    """Each case at dp = world (rank 0 writes it), then rank r runs the
    dp = 1 references of cases r, r + world, ..."""
    for case in cases:
        state = trained_state(case, world)
        if rank == 0:
            torch.save(state, os.path.join(out, f"{case}.dp.pt"))
    for case in cases[rank::world]:
        torch.save(trained_state(case, 1), os.path.join(out, f"{case}.ref.pt"))


def run_ppo_shard_local(rank, world, out, cases):
    """PPO's ``_optimize`` with shard-local minibatching from the parent's
    parameters, batch and per-shard epoch indices (``ppo_inputs.pt``)."""
    inputs = torch.load(os.path.join(out, "ppo_inputs.pt"))
    model = create_model(make_config("ppo.cuda", "locomotion.ant.cuda", **inputs["overrides"], **{
        "runner.device": "cpu", "runner.mesh_dp": world}))
    model.policy.module.load_state_dict(inputs["policy"])
    model.critic.load_state_dict(inputs["critic"])
    rows = inputs["batch"][0].shape[0] // world
    batch = tuple(x[rank * rows:(rank + 1) * rows] for x in inputs["batch"])
    metrics = model.mesh.mean_metrics(model._optimize(batch, epoch_indices=inputs["epoch_indices"]))
    if rank == 0:
        torch.save({"policy": model.policy.module.state_dict(), "critic": model.critic.state_dict(),
                    "metrics": {k: torch.as_tensor(v) for k, v in metrics.items()}},
                   os.path.join(out, "ppo_shard_local.dp.pt"))


def run_sac_shard_local(rank, world, out, cases):
    """SAC's sample and update with shard-local sampling from the parent's
    states, replay and injected ``t_idx`` / ``e_idx`` and noises
    (``sac_inputs.pt``)."""
    inputs = torch.load(os.path.join(out, "sac_inputs.pt"))
    model = create_model(make_config("sac.cuda", "classic.pendulum.cuda", **inputs["overrides"], **{
        "runner.device": "cpu", "runner.mesh_dp": world}))
    for name in ("policy", "critic", "alpha"):
        getattr(model, name).module.load_state_dict(inputs[name])
    model.critic.target.load_state_dict(inputs["critic_target"])
    buffer = model._make_buffer()
    first, last = model.mesh.rows_of_rank(model.nr_envs)
    for t in range(inputs["replay"]["observation"].shape[0]):
        rb.add(buffer, {k: v[t, first:last] for k, v in inputs["replay"].items()})
    batch = model._sample(buffer, t_idx=inputs["t_idx"], e_idx=inputs["e_idx"])
    metrics = model.mesh.mean_metrics(model.update(batch, 0, **model.local_update_draws(inputs["draws"])))
    torch.save({"batch": batch}, os.path.join(out, f"sac_shard_local.batch{rank}.pt"))
    if rank == 0:
        torch.save({"policy": model.policy.module.state_dict(), "critic": model.critic.module.state_dict(),
                    "critic_target": model.critic.target.state_dict(), "alpha": model.alpha.module.state_dict(),
                    "metrics": {k: torch.as_tensor(v) for k, v in metrics.items()}},
                   os.path.join(out, "sac_shard_local.dp.pt"))


def run_tp(rank, world, out, cases):
    """PPO at dp = 2 x tp = 2 for one iteration; rank 0 writes the whole
    parameters, Adam's moments and a forward of fixed observations."""
    model = create_model(_tp_config())
    model.train()
    tree = model.checkpoint_tree()
    obs = torch.linspace(-1.0, 1.0, 6 * 34).reshape(6, 34)
    with torch.no_grad():
        forward = {"policy": model.policy.module(obs)[0], "critic": model.critic(obs)}
    if rank == 0:
        torch.save({"tree": tree, "forward": forward}, os.path.join(out, "tp.dp.pt"))


def _tp_config():
    algorithm, environment, overrides = FAMILIES["ppo_ant"]
    return make_config("ppo.cuda", environment, **{
        **overrides, "runner.device": "cpu", "environment.seed": 5, "algorithm.logging_active": False,
        "algorithm.policy_hidden_sizes": (16, 8), "algorithm.critic_hidden_sizes": (16, 8),
        "runner.mesh_dp": 2, "runner.mesh_tp": 2, "runner.save_optimizer_state": True})


def run_checkpoints(rank, world, out, cases):
    """Checkpoints at dp = ``world`` through the runner (in ``out``): PPO
    trained and saved with its optimizer state (only rank 0 writes the run
    directory's files), then loaded on every rank (a load broadcasts rank
    0's file); FlashSAC's checkpoint, whose held noise and reward
    normalizer hold one row per env, saved whole and loaded through
    ``load`` into each rank's rows."""
    from rlx_tpu_torch.runner.runner import Runner

    os.chdir(out)
    common = ["--runner.device=cpu", f"--runner.mesh_dp={world}", "--environment.nr_envs=4",
              "--runner.save_model=True", "--runner.save_optimizer_state=True", "--runner.track_console=True"]
    model = Runner(["--algorithm.name=ppo.cuda", "--environment.name=classic.pendulum.cuda", "--runner.run_name=ppo",
                    "--algorithm.nr_steps=8", "--algorithm.minibatch_size=8", "--algorithm.nr_epochs=1",
                    "--algorithm.total_timesteps=32", "--environment.horizon=8",
                    "--algorithm.policy_hidden_sizes=(16, 16)", "--algorithm.critic_hidden_sizes=(16, 16)"]
                   + common).run()
    path = os.path.join(out, "runs", "rlx_tpu_torch", "default", "ppo", "models", "latest.model")
    loaded = type(model).load(_with_load(model.config, path), model.train_env, model.eval_env, None, None, [])
    state = {"trained": model.checkpoint_tree(), "loaded": loaded.checkpoint_tree(),
             "files": sorted(os.listdir(os.path.join(out, "runs", "rlx_tpu_torch", "default", "ppo")))}

    flash = Runner(["--algorithm.name=flashsac.cuda", "--environment.name=classic.pendulum.cuda",
                    "--runner.run_name=flashsac", "--algorithm.total_timesteps=40", "--algorithm.learning_starts=8",
                    "--algorithm.batch_size=8", "--algorithm.logging_frequency=16", "--algorithm.buffer_size=64",
                    "--algorithm.evaluation_active=False", "--algorithm.policy_hidden_dim=8",
                    "--algorithm.critic_hidden_dim=16", "--algorithm.policy_nr_blocks=1",
                    "--algorithm.critic_nr_blocks=1", "--algorithm.nr_atoms=11"] + common).run()
    flash.save("resume.model")
    saved = flash.checkpoint_tree()["full"]
    path = os.path.join(out, "runs", "rlx_tpu_torch", "default", "flashsac", "models", "resume.model")
    loaded = type(flash).load(_with_load(flash.config, path), flash.train_env, flash.eval_env, None, None, [])
    state["flashsac"] = {"saved": {name: saved[name] for name in flash.env_row_states if name in saved},
                         "rank_rows": {name: getattr(flash, name) for name in flash.env_row_states if name in saved},
                         "loaded_rows": {name: getattr(loaded, name) for name in flash.env_row_states
                                         if name in saved},
                         "rank": rank}
    torch.save(state, os.path.join(out, f"checkpoints.rank{rank}.pt"))


def _with_load(config, path):
    from rlx_tpu_torch.utils.config_dict import ConfigDict

    return ConfigDict(config, runner=ConfigDict(config.runner, load_model=path, save_model=False))


SUITES = {"families": run_families, "checkpoints": run_checkpoints, "ppo_shard_local": run_ppo_shard_local,
          "sac_shard_local": run_sac_shard_local, "tp": run_tp}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--suite", required=True, help=f"comma-separated, of {sorted(SUITES)}")
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--init", required=True, help="rendezvous file")
    parser.add_argument("--out", required=True)
    parser.add_argument("--cases", nargs="*", default=[])
    args = parser.parse_args()
    torch.set_num_threads(1)
    try:
        os.environ.update(WORLD_SIZE=str(args.world), RANK=str(args.rank), LOCAL_RANK=str(args.rank))
        mesh_lib.initialize_distributed(f"file://{args.init}", backend="gloo",
                                        timeout=datetime.timedelta(seconds=60))
        for suite in args.suite.split(","):
            SUITES[suite](args.rank, args.world, args.out, args.cases)
        dist.all_reduce(torch.zeros(1))   # every rank done before any leaves
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(args.out, f"rank{args.rank}.error"), "w") as f:
            f.write(traceback.format_exc())
        raise
    if "jax" in sys.modules:
        raise RuntimeError("a mesh worker imported jax")


if __name__ == "__main__":
    main()
