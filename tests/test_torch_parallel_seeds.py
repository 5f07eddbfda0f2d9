"""Parallel seeds (``algorithm.nr_parallel_seeds = S > 1``) in the port, on
the CPU, without JAX (its vmapped programs compile for minutes; the JAX
parity of single updates is in ``test_torch_parallel_seeds_parity.py``):

- the port's contract: seed s of an S = 3 run equals the one-seed run at
  ``seed_for(seed, s)`` after two iterations (f32; the seed-batched
  products round apart from the one-seed ones, so parameters are held at
  1e-5 relative + absolute and eval returns at 1e-4), for every family that
  runs parallel seeds;
- no leak: seed 1 run from another seed leaves seed 0's final parameters
  equal bit for bit;
- the JAX package's assertions (``tests/test_parallel_seeds.py``,
  ``tests/test_ppo.py``): ``eval_history`` is ``[S, evals]``, finite, the
  seeds differ, and logging, saving and the chunked program refuse S > 1;
- every registered family either runs at S = 2 or raises
  ``NotImplementedError`` (never ``KeyError``), and so does every env;
- the pieces: per-seed env draws, ``seed_for``, the per-seed clip and the
  masked per-seed Adam step (ESPO's early stop).
"""

import functools

import numpy as np
import pytest
import torch

from rlx_tpu_torch.algorithms import parallel_seeds
from rlx_tpu_torch.algorithms.algorithm_manager import registered_algorithm_names
from rlx_tpu_torch.algorithms.parallel_seeds import masked_adam_step, seed_for
from rlx_tpu_torch.algorithms.train_state import TrainState, clip_by_global_norm_
from rlx_tpu_torch.algorithms.training_program import run_training_program
from rlx_tpu_torch.config import create_env, create_model, import_for, make_config
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

SEED = 11
SMALL_NETS = {"algorithm.policy_hidden_sizes": (16, 16), "algorithm.critic_hidden_sizes": (16, 16)}
# 2 iterations of 2 envs x 8 steps, an eval after each (horizon 8)
ON_POLICY = {"environment.nr_envs": 2, "algorithm.nr_steps": 8, "algorithm.total_timesteps": 32,
             "algorithm.evaluation_and_save_frequency": 16, "environment.horizon": 8}
PPO = {**ON_POLICY, **SMALL_NETS, "algorithm.minibatch_size": 8, "algorithm.nr_epochs": 2}
RECURRENT = {**ON_POLICY, "environment.mask_velocity": True, "algorithm.nr_minibatches": 2,
             "algorithm.nr_epochs": 2, "algorithm.obs_encoding_dim": 16, "algorithm.rnn_hidden_dim": 16}
# a prefill of 8 steps, 16 learning steps, an eval after 8 of them
OFF_POLICY = {"environment.nr_envs": 2, "algorithm.total_timesteps": 48, "algorithm.learning_starts": 16,
              "algorithm.batch_size": 8, "algorithm.logging_frequency": 8, "algorithm.buffer_size": 64,
              "algorithm.evaluation_and_save_frequency": 16, "environment.horizon": 8}
PENDULUM, CARTPOLE = "classic.pendulum.cuda", "classic.cart_pole.cuda"
FAMILIES = {
    "ppo": (PENDULUM, PPO),
    "ppo_discrete": (CARTPOLE, PPO),
    "ppo_history_window": (PENDULUM, {**PPO, "environment.mask_velocity": True}),
    "ppo_memory_actions": (PENDULUM, {**PPO, "environment.mask_velocity": True}),
    # a ratio bound that the seeds pass in different epochs
    "espo": (PENDULUM, {**ON_POLICY, **SMALL_NETS, "algorithm.nr_epochs": 6, "algorithm.max_ratio_delta": 0.02,
                        "algorithm.learning_rate": 3e-3, "algorithm.minibatch_size": 16}),
    "ppo_dtrl": (PENDULUM, PPO),
    "ppo_lstm": (PENDULUM, RECURRENT),
    "ppo_gru": (PENDULUM, RECURRENT),
    "ppo_mamba2": (PENDULUM, RECURRENT),
    "ppo_transformer": (PENDULUM, RECURRENT),
    "reppo": (PENDULUM, {**ON_POLICY, "algorithm.policy_hidden_dim": 16, "algorithm.critic_hidden_dim": 16,
                         "algorithm.nr_minibatches": 2, "algorithm.nr_epochs": 2}),
    # episodes long enough for the seeds' returns to differ
    "pqn": (CARTPOLE, {**ON_POLICY, "algorithm.critic_hidden_sizes": (16, 16), "algorithm.nr_minibatches": 2,
                       "algorithm.nr_epochs": 2, "environment.horizon": 40}),
    "sac": (PENDULUM, {**OFF_POLICY, **SMALL_NETS}),
    "simba": (PENDULUM, {**OFF_POLICY, "algorithm.policy_hidden_dim": 16, "algorithm.critic_hidden_dim": 16}),
    "td3": (PENDULUM, {**OFF_POLICY, **SMALL_NETS, "algorithm.policy_delay": 2}),
    "ddpg": (PENDULUM, {**OFF_POLICY, **SMALL_NETS}),
    # the n-step sampler and the running normalizer, per seed
    "fasttd3": (PENDULUM, {**OFF_POLICY, **SMALL_NETS, "algorithm.n_step": 3, "algorithm.nr_atoms": 11}),
    "dqn": (CARTPOLE, {**OFF_POLICY, "algorithm.critic_hidden_sizes": (16, 16)}),
    "ddqn": (CARTPOLE, {**OFF_POLICY, "algorithm.critic_hidden_sizes": (16, 16)}),
    "c51": (CARTPOLE, {**OFF_POLICY, "algorithm.critic_hidden_sizes": (16, 16), "algorithm.nr_atoms": 11}),
    "dqn_hl_gauss": (CARTPOLE, {**OFF_POLICY, "algorithm.critic_hidden_sizes": (16, 16),
                                "algorithm.nr_atoms": 11}),
}
SUPPORTED = {case.split("_discrete")[0] for case in FAMILIES}


def _config(case, seed, nr_seeds, **extra):
    algorithm = case.split("_discrete")[0]
    environment, overrides = FAMILIES[case]
    return make_config(f"{algorithm}.cuda", environment, **{
        **overrides, "runner.device": "cpu", "environment.seed": seed, "algorithm.logging_active": False,
        "algorithm.nr_parallel_seeds": nr_seeds, **extra})


def _nets(model):
    """{name: module} of every net of a model (targets included)."""
    nets = {}
    for name in ("policy", "critic", "alpha", "q_net"):
        state = getattr(model, name, None)
        if isinstance(state, TrainState):
            nets[name] = state.module
            if state.target is not None:
                nets[f"{name}_target"] = state.target
        elif isinstance(state, torch.nn.Module):
            nets[name] = state
        elif state is not None and isinstance(getattr(state, "module", None), torch.nn.Module):
            nets[name] = state.module   # PPO's policy adapter
    return nets


@functools.lru_cache(maxsize=None)
def _seed_run(case, shift_seed_one=False):
    """(seed-stacked parameters, eval history) of an S = 3 run, read before
    ``train()`` keeps seed 0 only; with ``shift_seed_one`` seed 1 runs from
    another seed."""
    original = parallel_seeds.seed_for
    if shift_seed_one:
        parallel_seeds.seed_for = lambda seed, s: original(seed, s) + (1000 if s == 1 else 0)
    try:
        model = create_model(_config(case, SEED, 3))
    finally:
        parallel_seeds.seed_for = original
    _, eval_history = run_training_program(model)
    params = {f"{net}.{k}": v.detach().clone() for net, module in _nets(model).items()
              for k, v in module.named_parameters()}
    return params, eval_history


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_seed_s_is_the_one_seed_run_at_seed_for(case):
    params, eval_history = _seed_run(case)
    for s in (0, 2):
        model = create_model(_config(case, seed_for(SEED, s), 1))
        model.train()
        ours = {f"{net}.{k}": v for net, module in _nets(model).items() for k, v in module.named_parameters()}
        assert set(ours) == set(params)
        for key, value in ours.items():
            torch.testing.assert_close(params[key][s], value, rtol=1e-5, atol=1e-5,
                                       msg=lambda m: f"seed {s} {key}: {m}")
        for key, value in model.eval_history.items():
            if key != "steps":
                np.testing.assert_allclose(eval_history[key][s], value, rtol=1e-4, atol=1e-4, err_msg=f"{s} {key}")


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_another_seed_one_leaves_seed_zero_bit_for_bit(case):
    params, _ = _seed_run(case)
    shifted, _ = _seed_run(case, shift_seed_one=True)
    assert not all(torch.equal(params[k][1], shifted[k][1]) for k in params)
    for key in params:
        assert torch.equal(params[key][0], shifted[key][0]), key
        assert torch.equal(params[key][2], shifted[key][2]), key


@pytest.mark.parametrize("case", ["ppo", "sac", "fasttd3", "ppo_lstm", "reppo", "pqn"])
def test_eval_history_is_per_seed(case):
    """The JAX package's assertions: ``[S, evals]``, finite, the seeds
    differ, and after ``train()`` the model is seed 0's."""
    params, eval_history = _seed_run(case)
    returns = eval_history["eval/episode_return"]
    assert returns.shape == (3, 2) and np.isfinite(returns).all()
    assert len({float(r) for r in returns[:, -1]}) > 1
    model = create_model(_config(case, SEED, 3))
    model.train()
    assert model.eval_history["steps"].shape == (2,)
    assert model.eval_history["eval/episode_return"].shape == (3, 2)
    for net, module in _nets(model).items():
        for k, v in module.named_parameters():
            assert torch.equal(v, params[f"{net}.{k}"][0]), (net, k)
    assert model.test(1)   # test mode runs on seed 0's nets


@pytest.mark.parametrize("case", ["ppo", "sac", "pqn", "reppo", "ppo_lstm"])
def test_guards_refuse_callbacks(case):
    with pytest.raises(ValueError, match="logging_active"):
        create_model(_config(case, SEED, 2, **{"algorithm.logging_active": True}))
    with pytest.raises(ValueError, match="save_model"):
        create_model(_config(case, SEED, 2, **{"runner.save_model": True}))
    with pytest.raises(ValueError, match="chunked_train"):
        create_model(_config(case, SEED, 2, **{"runner.chunked_train": True}))


def _all_algorithms():
    import pkgutil

    import rlx_tpu_torch.algorithms as package

    names = [m.name for m in pkgutil.iter_modules(package.__path__) if m.ispkg]
    for name in names:
        import_for("algorithms", f"{name}.cuda")
    return sorted(n.split(".")[0] for n in registered_algorithm_names())


def test_every_family_runs_or_refuses():
    """Every registered family has the key (no ``KeyError``) and at S = 2
    either builds a seed-stacked model or raises ``NotImplementedError``
    naming the ROADMAP item."""
    refused = []
    for algorithm in _all_algorithms():
        discrete = algorithm in ("dqn", "ddqn", "c51", "dqn_hl_gauss", "pqn")
        config = make_config(f"{algorithm}.cuda", CARTPOLE if discrete else PENDULUM, **{
            "runner.device": "cpu", "algorithm.nr_parallel_seeds": 2, "algorithm.logging_active": False,
            "environment.nr_envs": 4})
        if algorithm in SUPPORTED:
            model = create_model(config)
            assert model.parallel.nr_seeds == 2 and model.train_env.nr_envs == 8, algorithm
        else:
            with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 19c"):
                create_model(config)
            refused.append(algorithm)
    assert {"fastsac", "flashsac", "redq", "droq", "aqe", "tqc", "xqc", "simbav2", "crossq", "bro", "mpo",
            "fastmpo"} == set(refused)


@pytest.mark.parametrize("environment", ["classic.pixel_grid.cuda", "locomotion.robot.cuda",
                                         "native.pendulum.host"])
def test_envs_without_per_seed_draws_refuse(environment):
    algorithm = "dqn" if "pixel" in environment else "ppo"
    config = make_config(f"{algorithm}.cuda", environment, **{
        "runner.device": "cpu", "algorithm.nr_parallel_seeds": 2, "algorithm.logging_active": False,
        "environment.nr_envs": 2})
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 19c"):
        create_env(config)


@pytest.mark.parametrize("environment, overrides", [
    ("locomotion.ant.cuda", {"environment.initial_state_noise": 0.1, "environment.perturbation_chance": 0.5}),
    (PENDULUM, {}), (CARTPOLE, {}), (PENDULUM, {"environment.mask_velocity": True}),
])
def test_env_rows_of_a_seed_are_its_one_seed_env(environment, overrides):
    """An env of S * N envs reset with S seeds steps seed s's rows as the
    env of N envs reset with seed s's seed, under the same actions."""
    seeded = lambda S: make_config("ppo.cuda", environment, **{
        **overrides, "runner.device": "cpu", "environment.nr_envs": 3, "algorithm.nr_parallel_seeds": S,
        "algorithm.logging_active": False})
    env, _ = create_env(seeded(2))
    single, _ = create_env(seeded(1))
    seeds = [5, 9]
    state = env.reset(seeds)
    states = [single.reset(x) for x in seeds]
    assert torch.equal(state.observation, torch.cat([st.observation for st in states]))
    rng = np.random.default_rng(0)
    discrete = environment == CARTPOLE
    # the Ant's plain engine is slow on the CPU: its 4 steps each draw kicks
    for _ in range(4 if "ant" in environment else 12):
        if discrete:
            action = torch.tensor(rng.integers(0, 2, size=6), dtype=torch.int32)
        else:
            action = torch.tensor(rng.uniform(-1, 1, size=(6,) + tuple(env.single_action_space.shape)),
                                  dtype=torch.float32)
        state = env.step(state, action)
        states = [single.step(st, action[3 * s:3 * s + 3]) for s, st in enumerate(states)]
        for field in ("observation", "reward", "terminated", "truncated"):
            # the Ant's plain engine solves its batch at once, so 6 envs and
            # 3 round apart in the last bits, which its contacts amplify over
            # the steps (a draw of another seed's would be off by ~0.1); the
            # classic envs are exact
            tol = 1e-4 if "ant" in environment else 0.0
            torch.testing.assert_close(getattr(state, field), torch.cat([getattr(st, field) for st in states]),
                                       rtol=tol, atol=tol, msg=lambda m: f"{field}: {m}")


def test_seed_for():
    assert seed_for(7, 0) == 7
    assert len({seed_for(7, s) for s in range(100)}) == 100
    assert seed_for(0, 1) != 1   # the seeds of a run stay apart from the next runs' seeds


def test_clip_is_per_seed():
    grads = [torch.tensor([[3.0, 4.0], [0.3, 0.4]]), torch.tensor([[0.0], [0.0]])]
    norms = clip_by_global_norm_(grads, 1.0, per_seed=True)
    torch.testing.assert_close(norms, torch.tensor([5.0, 0.5]))
    torch.testing.assert_close(grads[0], torch.tensor([[0.6, 0.8], [0.3, 0.4]]))


def test_masked_adam_step_is_adam_per_seed():
    """Each active seed steps as torch's Adam at its own count and rate; an
    inactive seed keeps its parameters, moments and count."""
    torch.manual_seed(0)
    start = torch.randn(2, 5)
    stacked = torch.nn.Parameter(start.clone())
    optimizer = torch.optim.Adam([stacked], lr=1e-2, eps=1e-8)
    singles = [torch.nn.Parameter(start[s].clone()) for s in range(2)]
    references = [torch.optim.Adam([p], lr=lr, eps=1e-8) for p, lr in zip(singles, (1e-2, 3e-3))]
    for step, active in enumerate(([True, True], [True, False], [True, True])):
        grad = torch.randn(2, 5)
        stacked.grad = grad.clone()
        masked_adam_step(optimizer, torch.tensor(active), [1e-2, 3e-3])
        for s in range(2):
            if active[s]:
                singles[s].grad = grad[s].clone()
                references[s].step()
            torch.testing.assert_close(stacked.detach()[s], singles[s].detach(), rtol=1e-6, atol=1e-7,
                                       msg=lambda m: f"step {step} seed {s}: {m}")
    assert optimizer.state[stacked]["step"].tolist() == [3.0, 2.0]
