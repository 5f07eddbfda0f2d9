"""Learning checks of the port on the card against the JAX package's records.

    python -m rlx_tpu_torch.benchmarks.curves pendulum_spot_fasttd3 --seeds 0 1 2 \
        --out chiprun_out/pendulum_spot_fasttd3.json
    python -m rlx_tpu_torch.benchmarks.curves pendulum_ppo --seeds 1 2 3
    python -m rlx_tpu_torch.benchmarks.curves pendulum_spot_sac --seeds 0
    python -m rlx_tpu_torch.benchmarks.curves pendulum_spot_flashsac --seeds 0 1 2
    python -m rlx_tpu_torch.benchmarks.curves cartpole_spot_c51 --seeds 0 1 2
    python -m rlx_tpu_torch.benchmarks.curves pendulum_masked_ppo --seeds 1 2 3
    python -m rlx_tpu_torch.benchmarks.curves pendulum_masked_lstm --seeds 1 2 3
    python -m rlx_tpu_torch.benchmarks.curves pendulum_spot_mpo --seeds 1 2 3
    python -m rlx_tpu_torch.benchmarks.curves pendulum_spot_reppo --seeds 0
    python -m rlx_tpu_torch.benchmarks.curves locomotion_lstm --seeds 1 2 3
    python -m rlx_tpu_torch.benchmarks.curves pixel_chase_dqn pixel_chase_dqn_stack1 --seeds 0 1 2
    python -m rlx_tpu_torch.benchmarks.curves hopper_ppo --seeds 1 2 3
    python -m rlx_tpu_torch.benchmarks.curves dmc_walker_walk_sac --seeds 1 2 3
    python -m rlx_tpu_torch.benchmarks.curves pendulum_spot_sac --parallel-seeds 3 --seeds 0 \
        --out chiprun_out/pendulum_spot_sac_parallel3_seed0.json

Each recipe is the JAX package's (``benchmarks/curves.py``): the same
budget, evaluation points, overrides and threshold (an on-policy run's evaluation
interval rounded down to a multiple of its rollout batch, as there), so the
outcome reads against ``benchmarks/results/<name>.json``.  Each seed trains on its own in
turn, or with ``--parallel-seeds N`` the N seeds ``seed_for(seed, s)`` of the
one ``--seeds`` value train as one program (the JAX package's flag; its
record carries ``"parallel_seeds": N`` and the shared wall time, and is
kept beside the one-seed records, as ``<name>_parallel<N>_seed<seed>.json``);
a seed's final return is the mean of its last three evaluations of the
recipe's metric (the episode return, or for the locomotion family the
episode's velocity tracking, ``eval/episode_tracking``), and the
check passes when every seed's final return clears the threshold (or, for a
negative control marked ``"expect": "below"``, stays below it).  A recipe
runs on the card, and prints the card's name and power limit beside the
result, unless it names ``"device": "cpu"``: the host-env recipes, whose
MuJoCo and dm_control envs need packages only a CPU machine has (the JAX
package's records of them are CPU runs too).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

# benchmarks/curves.py: _PENDULUM_OFFPOLICY
PENDULUM_OFFPOLICY = {
    "algorithm.learning_starts": 1_000, "algorithm.buffer_size": 100_000,
    "algorithm.batch_size": 128, "algorithm.logging_frequency": 2_000, "environment.nr_envs": 8,
}

# benchmarks/curves.py: _MASKED (observation [cos th, sin th] only)
MASKED = {
    "environment.nr_envs": 8, "environment.mask_velocity": True,
    "algorithm.nr_steps": 256, "algorithm.learning_rate": 5e-4, "algorithm.gamma": 0.9,
}

# benchmarks/curves.py: the locomotion recipes' shared overrides
LOCOMOTION = {
    "environment.nr_envs": 4096, "algorithm.nr_steps": 32, "algorithm.learning_rate": 3e-4,
    "algorithm.logging_active": False,
}

# benchmarks/curves.py: _REF_PPO, the reference's PPO hyperparameters
# (`rl_x/algorithms/ppo/flax/default_config.py`), 8 envs x 256 steps
REF_PPO = {
    "algorithm.learning_rate": 3e-4, "algorithm.anneal_learning_rate": False, "algorithm.nr_steps": 2048 // 8,
    "algorithm.nr_epochs": 10, "algorithm.minibatch_size": 64, "algorithm.gamma": 0.99,
    "algorithm.gae_lambda": 0.95, "algorithm.clip_range": 0.2, "algorithm.entropy_coef": 0.0,
    "algorithm.critic_coef": 0.5, "algorithm.max_grad_norm": 0.5,
    "algorithm.action_clipping_and_rescaling": True, "algorithm.policy_hidden_sizes": (256, 256),
    "algorithm.critic_hidden_sizes": (256, 256),
}

# benchmarks/curves.py: the pixel_chase_dqn recipes' overrides
PIXEL_CHASE = {
    "environment.nr_envs": 128, "algorithm.learning_starts": 10_000, "algorithm.buffer_size": 30_000,
    "algorithm.batch_size": 256, "algorithm.learning_rate": 1e-4, "algorithm.epsilon_decay_steps": 150_000,
    "algorithm.target_update_frequency": 4_000, "algorithm.update_frequency": 1,
}

RUNS = {
    # benchmarks/curves.py: hopper_ppo and dmc_walker_walk_sac, host envs on
    # the CPU (Gymnasium's MuJoCo Hopper; the native C++ dm_control walker,
    # one env, one update an env step)
    "hopper_ppo": {
        "algorithm": "ppo.cuda", "environment": "gym.mujoco.hopper_v5.host", "device": "cpu",
        "budget": 300_000, "threshold": 800.0, "eval_points": 12,
        "overrides": {**REF_PPO, "environment.nr_envs": 8},
    },
    "dmc_walker_walk_sac": {
        "algorithm": "sac.cuda", "environment": "native.dmc_walker_walk.host", "device": "cpu",
        "budget": 150_000, "threshold": 300.0, "eval_points": 8,
        "overrides": {"environment.nr_envs": 1},
    },
    # benchmarks/curves.py: pendulum_ppo (gamma 0.9, 8 envs x 256 steps)
    "pendulum_ppo": {
        "algorithm": "ppo.cuda", "environment": "classic.pendulum.cuda",
        "budget": 200_000, "threshold": -700.0, "eval_points": 10,
        "overrides": {
            "algorithm.nr_steps": 256, "algorithm.minibatch_size": 512,
            "algorithm.nr_epochs": 10, "algorithm.learning_rate": 1e-3,
            "algorithm.gamma": 0.9, "environment.nr_envs": 8,
        },
    },
    # benchmarks/curves.py: _PENDULUM_OFFPOLICY plus the categorical support
    # that covers Pendulum's raw returns
    "pendulum_spot_fasttd3": {
        "algorithm": "fasttd3.cuda", "environment": "classic.pendulum.cuda",
        "budget": 100_000, "threshold": -500.0, "eval_points": 8,
        "overrides": {**PENDULUM_OFFPOLICY, "algorithm.v_min": -800.0, "algorithm.v_max": 100.0},
    },
    # benchmarks/curves.py: the pendulum_spot_* family checks
    **{f"pendulum_spot_{name}": {
        "algorithm": f"{name}.cuda", "environment": "classic.pendulum.cuda",
        "budget": 100_000, "threshold": -500.0, "eval_points": 8, "overrides": dict(PENDULUM_OFFPOLICY),
    } for name in ("sac", "td3", "ddpg", "redq", "tqc", "droq", "crossq", "fastsac", "aqe", "xqc", "simba",
                   "simbav2", "flashsac", "bro", "mpo", "fastmpo")},
    # benchmarks/curves.py: ESPO's full-batch epochs need small rollouts and
    # more epochs; Pendulum's torque is [-2, 2]
    "pendulum_spot_espo": {
        "algorithm": "espo.cuda", "environment": "classic.pendulum.cuda",
        "budget": 400_000, "threshold": -700.0, "eval_points": 4,
        "overrides": {
            "algorithm.nr_steps": 128, "algorithm.nr_epochs": 20, "algorithm.learning_rate": 1e-3,
            "algorithm.gamma": 0.9, "algorithm.action_clipping_and_rescaling": True, "environment.nr_envs": 8,
        },
    },
    # benchmarks/curves.py: the on-policy variants at the PPO Pendulum recipe
    "pendulum_spot_ppo_dtrl": {
        "algorithm": "ppo_dtrl.cuda", "environment": "classic.pendulum.cuda",
        "budget": 300_000, "threshold": -700.0, "eval_points": 6,
        "overrides": {
            "algorithm.nr_steps": 256, "algorithm.learning_rate": 1e-3, "algorithm.gamma": 0.9,
            "environment.nr_envs": 8, "algorithm.minibatch_size": 512, "algorithm.nr_epochs": 10,
        },
    },
    # benchmarks/curves.py: REPPO at a scaled-down version of its own regime
    # (256 envs x 128 steps, 8 minibatches of 4096), gamma and the HL-Gauss
    # support adapted to Pendulum's returns
    "pendulum_spot_reppo": {
        "algorithm": "reppo.cuda", "environment": "classic.pendulum.cuda",
        "budget": 4_000_000, "threshold": -700.0, "eval_points": 6,
        "overrides": {
            "algorithm.nr_steps": 128, "algorithm.nr_minibatches": 8, "algorithm.gamma": 0.9,
            "algorithm.v_min": -400.0, "algorithm.v_max": 50.0, "environment.nr_envs": 256,
        },
    },
    # benchmarks/curves.py: the cartpole_spot_* family checks
    **{f"cartpole_spot_{name}": {
        "algorithm": f"{name}.cuda", "environment": "classic.cart_pole.cuda",
        "budget": 250_000, "threshold": 250.0, "eval_points": 6, "overrides": {"environment.nr_envs": 8},
    } for name in ("dqn", "ddqn", "c51", "dqn_hl_gauss", "pqn")},
    # benchmarks/curves.py: the velocity-masked Pendulum memory suite
    "pendulum_masked_ppo": {   # feedforward control: must stay BELOW
        "algorithm": "ppo.cuda", "environment": "classic.pendulum.cuda",
        "budget": 400_000, "threshold": -700.0, "eval_points": 8, "expect": "below",
        "overrides": {**MASKED, "algorithm.minibatch_size": 512, "algorithm.nr_epochs": 10},
    },
    "pendulum_masked_history_window": {
        "algorithm": "ppo_history_window.cuda", "environment": "classic.pendulum.cuda",
        "budget": 400_000, "threshold": -700.0, "eval_points": 8,
        "overrides": {**MASKED, "algorithm.minibatch_size": 512, "algorithm.nr_epochs": 10,
                      "algorithm.window_length": 4},
    },
    # benchmarks/curves.py: the recurrent memory variants (4 minibatches of
    # 2 envs with the time axis intact, 10 epochs; the transformer at twice
    # the budget)
    **{f"pendulum_masked_{name}": {
        "algorithm": f"ppo_{name}.cuda", "environment": "classic.pendulum.cuda",
        "budget": 400_000, "threshold": -700.0, "eval_points": 8,
        "overrides": {**MASKED, "algorithm.nr_minibatches": 4, "algorithm.nr_epochs": 10},
    } for name in ("lstm", "gru", "mamba2", "transformer")},
    "pendulum_masked_memory_actions": {
        "algorithm": "ppo_memory_actions.cuda", "environment": "classic.pendulum.cuda",
        "budget": 1_200_000, "threshold": -700.0, "eval_points": 12,
        "overrides": {**MASKED, "algorithm.minibatch_size": 512, "algorithm.nr_epochs": 10,
                      "algorithm.memory_action_dimension": 4},
    },
    # benchmarks/curves.py: the robot locomotion family, read on the
    # normalized velocity tracking of an episode (rollout/episode_tracking,
    # 1 - mean |v - v_cmd| / v_max), 4096 envs x 32 steps
    "locomotion_ppo": {
        "algorithm": "ppo.cuda", "environment": "locomotion.robot.cuda",
        "budget": 150_000_000, "threshold": 0.5, "eval_points": 10, "metric": "eval/episode_tracking",
        "overrides": {**LOCOMOTION, "algorithm.minibatch_size": 32768, "algorithm.nr_epochs": 4},
    },
    "locomotion_lstm": {
        "algorithm": "ppo_lstm.cuda", "environment": "locomotion.robot.cuda",
        "budget": 50_000_000, "threshold": 0.5, "eval_points": 10, "metric": "eval/episode_tracking",
        "overrides": {**LOCOMOTION, "algorithm.nr_minibatches": 4, "algorithm.nr_epochs": 4,
                      "algorithm.rnn_hidden_dim": 128},
    },
    "locomotion_ppo_bf16": {
        "algorithm": "ppo.cuda", "environment": "locomotion.robot.cuda",
        "budget": 50_000_000, "threshold": 0.5, "eval_points": 10, "metric": "eval/episode_tracking",
        "overrides": {**LOCOMOTION, "algorithm.minibatch_size": 32768, "algorithm.nr_epochs": 4,
                      "algorithm.compute_dtype": "bfloat16"},
    },
    "soccer_lstm": {
        "algorithm": "ppo_lstm.cuda", "environment": "locomotion.soccer.cuda",
        "budget": 100_000_000, "threshold": 0.5, "eval_points": 10, "metric": "eval/episode_tracking",
        "overrides": {**LOCOMOTION, "algorithm.nr_minibatches": 4, "algorithm.nr_epochs": 4,
                      "algorithm.rnn_hidden_dim": 128},
    },
    # benchmarks/curves.py: DQN with NatureCNN on the 84x84x4 pixel_chase
    # frames (uint8 replay), and its negative control on one frame, which
    # cannot see where the goal drifts and must stay below the bar
    "pixel_chase_dqn": {
        "algorithm": "dqn.cuda", "environment": "classic.pixel_chase.cuda",
        "budget": 400_000, "threshold": 0.6, "eval_points": 8,
        "overrides": dict(PIXEL_CHASE),
    },
    "pixel_chase_dqn_stack1": {
        "algorithm": "dqn.cuda", "environment": "classic.pixel_chase.cuda",
        "budget": 400_000, "threshold": 0.6, "eval_points": 8, "expect": "below",
        "overrides": {"environment.nr_envs": 128, "environment.frame_stack": 1,
                      **{k: v for k, v in PIXEL_CHASE.items() if k != "environment.nr_envs"}},
    },
}
RUNS["pendulum_masked_transformer"].update(budget=800_000, eval_points=10)
# benchmarks/curves.py: the categorical and HL-Gauss supports over Pendulum's
# raw returns; SimbaV2 and FlashSAC with gamma 0.9, a [-300, 0] support,
# 150k steps and the reward normalizer off (SimbaV2's observation
# normalizer too)
for name in ("fastsac", "xqc", "fastmpo"):
    RUNS[f"pendulum_spot_{name}"]["overrides"].update({"algorithm.v_min": -800.0, "algorithm.v_max": 100.0})
# benchmarks/curves.py: MPO at 4 envs (a reference-like update:data
# ratio) with the observation normalizer, 150k steps and a -800 bar; BRO
# without its periodic resets
RUNS["pendulum_spot_mpo"]["budget"] = 150_000
RUNS["pendulum_spot_mpo"]["threshold"] = -800.0
RUNS["pendulum_spot_mpo"]["overrides"].update({
    "algorithm.batch_size": 256, "algorithm.enable_observation_normalization": True, "environment.nr_envs": 4,
})
RUNS["pendulum_spot_bro"]["overrides"]["algorithm.reset_interval"] = 10**9
for name in ("simbav2", "flashsac"):
    RUNS[f"pendulum_spot_{name}"]["budget"] = 150_000
    RUNS[f"pendulum_spot_{name}"]["overrides"].update({
        "algorithm.gamma": 0.9, "algorithm.v_min": -300.0, "algorithm.v_max": 0.0,
        "algorithm.enable_reward_normalization": False,
    })
RUNS["pendulum_spot_simbav2"]["overrides"]["algorithm.enable_observation_normalization"] = False
# benchmarks/curves.py: the DQN family's epsilon decay and target refresh
# recalibrated to the budget, the distributional supports over CartPole's
# returns, and the 400k budget of dqn, ddqn and dqn_hl_gauss
for name in ("dqn", "ddqn", "c51", "dqn_hl_gauss"):
    RUNS[f"cartpole_spot_{name}"]["overrides"].update({
        "algorithm.epsilon_decay_steps": 125_000, "algorithm.target_update_frequency": 2_000,
        "algorithm.learning_rate": 1e-3, "algorithm.batch_size": 128,
    })
for name in ("c51", "dqn_hl_gauss"):
    RUNS[f"cartpole_spot_{name}"]["overrides"].update({"algorithm.v_min": 0.0, "algorithm.v_max": 500.0})
for name in ("dqn", "ddqn", "dqn_hl_gauss"):
    RUNS[f"cartpole_spot_{name}"]["budget"] = 400_000
    RUNS[f"cartpole_spot_{name}"]["overrides"]["algorithm.epsilon_decay_steps"] = 200_000


def _train(spec, seed, **extra):
    """Train the recipe from ``environment.seed = seed`` (``extra`` overrides
    on top): (model, eval history, wall s of ``train()``)."""
    from rlx_tpu_torch.config import create_model, make_config

    budget, overrides, device = spec["budget"], spec["overrides"], spec.get("device", "cuda")
    # an algorithm key the config lacks (FastMPO's buffer_size: it sizes its
    # buffer per env) is added unread by the JAX package's make_config; the
    # port's raises, so it is left out here
    defaults = make_config(spec["algorithm"], spec["environment"], **{"runner.device": device}).algorithm
    overrides = {k: v for k, v in overrides.items()
                 if not k.startswith("algorithm.") or k.split(".", 1)[1] in defaults}
    eval_frequency = max(budget // spec["eval_points"], 1)
    if "algorithm.nr_steps" in overrides:
        batch = overrides["algorithm.nr_steps"] * overrides["environment.nr_envs"]
        eval_frequency = max(eval_frequency // batch, 1) * batch
    config = make_config(spec["algorithm"], spec["environment"], **{
        **overrides,
        "runner.device": device,
        "algorithm.total_timesteps": budget,
        "algorithm.evaluation_and_save_frequency": eval_frequency,
        "algorithm.evaluation_active": True,
        "algorithm.logging_active": False,
        "environment.seed": seed,
        **extra,
    })
    model = create_model(config)
    start = time.perf_counter()
    model.train()
    if device == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    model.train_env.close()
    model.eval_env.close()
    return model, model.eval_history, wall_s


def _curve(spec, seed, steps, returns, wall_s):
    returns = [float(r) for r in returns]
    return {
        "seed": seed,
        "metric": spec.get("metric", "eval/episode_return"),
        "steps": [int(s) for s in steps],
        "returns": returns,
        "final_return": sum(returns[-3:]) / len(returns[-3:]),
        "wall_s": wall_s,
    }


def run_seed(spec, seed):
    _, history, wall_s = _train(spec, seed)
    return _curve(spec, seed, history["steps"], history[spec.get("metric", "eval/episode_return")], wall_s)


def run_parallel_seeds(spec, seed, nr_seeds):
    """``nr_seeds`` seeds trained as ONE program (``algorithm.nr_parallel_seeds``,
    with the JAX package's overrides: logging, saving and the chunked program
    off), seed s being the one-seed run at ``seed_for(seed, s)``: one curve
    per seed from its row of ``eval_history``, each with the shared wall
    time."""
    from rlx_tpu_torch.algorithms.parallel_seeds import seed_for

    _, history, wall_s = _train(spec, seed, **{
        "algorithm.nr_parallel_seeds": nr_seeds, "runner.save_model": False, "runner.chunked_train": False})
    returns = history[spec.get("metric", "eval/episode_return")]
    return [_curve(spec, seed_for(seed, s), history["steps"], returns[s], wall_s) for s in range(nr_seeds)]


def passes(spec, final_return):
    if spec.get("expect", "above") == "below":
        return final_return < spec["threshold"]
    return final_return >= spec["threshold"]


def record(name, spec, seeds, card, parallel_seeds=1):
    """The record of one recipe's seeds: each seed's curve, final return and
    pass, and with parallel seeds the program's seed count and shared wall
    time."""
    device = spec.get("device", "cuda")
    result = {
        "name": name, "algorithm": spec["algorithm"], "environment": spec["environment"],
        "budget": spec["budget"], "threshold": spec["threshold"], "device": device,
        "card": card if device == "cuda" else None, "torch_threads": torch.get_num_threads(),
        "seeds": seeds,
        "expect": spec.get("expect", "above"),
        "per_seed_passed": [passes(spec, s["final_return"]) for s in seeds],
    }
    if parallel_seeds > 1:
        result["parallel_seeds"] = parallel_seeds
        result["wall_s"] = seeds[0]["wall_s"]
    result["passed"] = all(result["per_seed_passed"])
    return result


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("names", nargs="+", choices=sorted(RUNS), metavar="name")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--parallel-seeds", type=int, default=1, metavar="N",
                        help="train N seeds as one program (algorithm.nr_parallel_seeds) from the first of --seeds, "
                             "seed s at seed_for(seed, s)")
    parser.add_argument("--out", default=None, help="the record's path (one recipe)")
    args = parser.parse_args(argv)
    if args.out and len(args.names) > 1:
        parser.error("--out takes the record of one recipe")
    if args.parallel_seeds > 1 and len(args.seeds) > 1:
        parser.error("--parallel-seeds takes one --seeds value: the run's seed")
    card = None
    if any(RUNS[name].get("device", "cuda") == "cuda" for name in args.names):
        if not torch.cuda.is_available():
            sys.exit("no CUDA device: the learning checks run on the card")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for name in args.names:
        spec = RUNS[name]
        if args.parallel_seeds > 1:
            seeds = run_parallel_seeds(spec, args.seeds[0], args.parallel_seeds)
        else:
            seeds = [run_seed(spec, seed) for seed in args.seeds]
        result = record(name, spec, seeds, card, args.parallel_seeds)
        print(json.dumps(result))
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
