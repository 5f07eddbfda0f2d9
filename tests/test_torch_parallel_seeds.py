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
- every registered family builds at S = 2 (never ``KeyError``, none
  raises ``NotImplementedError`` any more), and an env either runs
  parallel seeds (every device env, the robot and soccer included) or, a
  host env, raises naming the ROADMAP item;
- per-seed running statistics: seed-stacked BatchRenorm and BatchNorm under
  ``ParallelSeeds.map`` give each seed the batch statistics of its own rows;
- the pieces: per-seed env draws, ``seed_for``, the per-seed clip and the
  masked per-seed Adam step (ESPO's early stop).
"""

import contextlib
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
from rlx_tpu_torch.models.layers import running_buffers
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

SEED = 11
SMALL_NETS = {"algorithm.policy_hidden_sizes": (16, 16), "algorithm.critic_hidden_sizes": (16, 16)}
SCALED_NETS = {"algorithm.policy_hidden_dim": 8, "algorithm.critic_hidden_dim": 16, "algorithm.policy_nr_blocks": 1,
               "algorithm.critic_nr_blocks": 1}
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
    # the twelve families of ROADMAP item 19c: the n-step sampler, the
    # normalizers, the running statistics, the projections and every draw
    # inside an update, per seed
    "fastsac": (PENDULUM, {**OFF_POLICY, **SMALL_NETS, "algorithm.n_step": 3, "algorithm.nr_atoms": 11}),
    "flashsac": (PENDULUM, {**OFF_POLICY, **SCALED_NETS, "algorithm.nr_atoms": 11}),
    "crossq": (PENDULUM, {**OFF_POLICY, **SMALL_NETS, "algorithm.policy_delay": 2}),
    "tqc": (PENDULUM, {**OFF_POLICY, **SMALL_NETS, "algorithm.nr_atoms_per_net": 5,
                       "algorithm.nr_dropped_atoms_per_net": 1}),
    "xqc": (PENDULUM, {**OFF_POLICY, **SCALED_NETS, "algorithm.nr_atoms": 11, "algorithm.policy_delay": 2}),
    "simbav2": (PENDULUM, {**OFF_POLICY, **SCALED_NETS, "algorithm.nr_atoms": 11}),
    "redq": (PENDULUM, {**OFF_POLICY, **SMALL_NETS, "algorithm.nr_critics": 4, "algorithm.q_update_steps": 2}),
    "droq": (PENDULUM, {**OFF_POLICY, **SMALL_NETS, "algorithm.dropout_rate": 0.2, "algorithm.q_update_steps": 2}),
    "aqe": (PENDULUM, {**OFF_POLICY, **SMALL_NETS, "algorithm.nr_critics": 4, "algorithm.nr_dropped_q_values": 1,
                       "algorithm.q_update_steps": 2}),
    # a reset inside the run: at learning step 4 and every 6 after it
    "bro": (PENDULUM, {**OFF_POLICY, **SCALED_NETS, "algorithm.nr_quantiles": 5, "algorithm.updates_per_step": 2,
                       "algorithm.first_reset_step": 8, "algorithm.reset_interval": 12}),
    "mpo": (PENDULUM, {**OFF_POLICY, **SMALL_NETS, "algorithm.nr_atoms": 11, "algorithm.action_sampling_number": 3,
                       "algorithm.target_network_update_period": 2}),
    "fastmpo": (PENDULUM, {**{k: v for k, v in OFF_POLICY.items() if k != "algorithm.buffer_size"}, **SMALL_NETS,
                           "algorithm.nr_atoms": 11,
                           "algorithm.action_sampling_number": 3, "algorithm.critic_network_type": "mpo",
                           "algorithm.policy_network_type": "mpo", "algorithm.learning_starts_per_env": 8,
                           "algorithm.buffer_size_per_env": 32, "algorithm.nr_critic_updates_per_policy_update": 2,
                           "algorithm.nr_policy_updates_per_step": 2, "algorithm.evaluation_active": True}),
}
SUPPORTED = {case.split("_discrete")[0] for case in FAMILIES}
# CrossQ runs in float64: a bias just before a train-mode BatchRenorm has a
# zero gradient but for rounding, which Adam turns into steps of up to the
# learning rate in f32, so the seed-batched and the one-seed products'
# rounding would part them by ~lr (test_torch_scaled_nets.py runs its JAX
# parity in float64 for the same reason)
FLOAT64 = {"crossq"}


@contextlib.contextmanager
def _dtype(case):
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64 if case in FLOAT64 else torch.float32)
    try:
        yield
    finally:
        torch.set_default_dtype(default)


def _config(case, seed, nr_seeds, **extra):
    algorithm = case.split("_discrete")[0]
    environment, overrides = FAMILIES[case]
    return make_config(f"{algorithm}.cuda", environment, **{
        **overrides, "runner.device": "cpu", "environment.seed": seed, "algorithm.logging_active": False,
        "algorithm.nr_parallel_seeds": nr_seeds, **extra})


def _nets(model):
    """{name: module} of every net of a model (targets included)."""
    nets = {}
    for name in ("policy", "critic", "alpha", "q_net", "optimistic_policy", "optimism", "regularizer", "duals"):
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


def _tensors(model):
    """{name: tensor} of a model's parameters, running statistics (BatchNorm,
    BatchRenorm) and off-policy dict states (normalizers, FlashSAC's noise,
    BRO's ``init_copy``), seed-stacked in a parallel run."""
    out = {}
    for net, module in _nets(model).items():
        out.update({f"{net}.{k}": v for k, v in module.named_parameters()})
        out.update({f"{net}.{k}": v for k, v in running_buffers(module).items()})
    for name in getattr(model, "state_names", ()):
        if isinstance(getattr(model, name), dict):
            out.update({f"{name}.{k}": v for k, v in getattr(model, name).items()})
    return out


@functools.lru_cache(maxsize=None)
def _seed_run(case, shift_seed_one=False):
    """(seed-stacked parameters, eval history) of an S = 3 run, read before
    ``train()`` keeps seed 0 only; with ``shift_seed_one`` seed 1 runs from
    another seed."""
    original = parallel_seeds.seed_for
    if shift_seed_one:
        parallel_seeds.seed_for = lambda seed, s: original(seed, s) + (1000 if s == 1 else 0)
    try:
        with _dtype(case):
            model = create_model(_config(case, SEED, 3))
    finally:
        parallel_seeds.seed_for = original
    with _dtype(case):
        _, eval_history = run_training_program(model)
    params = {k: v.detach().clone() for k, v in _tensors(model).items()}
    return params, eval_history


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_seed_s_is_the_one_seed_run_at_seed_for(case):
    params, eval_history = _seed_run(case)
    for s in (0, 2):
        with _dtype(case):
            model = create_model(_config(case, seed_for(SEED, s), 1))
            model.train()
        ours = _tensors(model)
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
    builds a seed-stacked model: none raises ``NotImplementedError``."""
    algorithms = _all_algorithms()
    assert len(algorithms) == 32 and set(algorithms) == SUPPORTED
    for algorithm in algorithms:
        discrete = algorithm in ("dqn", "ddqn", "c51", "dqn_hl_gauss", "pqn")
        config = make_config(f"{algorithm}.cuda", CARTPOLE if discrete else PENDULUM, **{
            "runner.device": "cpu", "algorithm.nr_parallel_seeds": 2, "algorithm.logging_active": False,
            "environment.nr_envs": 4})
        model = create_model(config)
        assert model.parallel.nr_seeds == 2 and model.train_env.nr_envs == 8, algorithm


@pytest.mark.parametrize("environment", ["native.pendulum.host"])
def test_envs_without_per_seed_draws_refuse(environment):
    """The host envs are the only ones left that refuse S > 1."""
    config = make_config("ppo.cuda", environment, **{
        "runner.device": "cpu", "algorithm.nr_parallel_seeds": 2, "algorithm.logging_active": False,
        "environment.nr_envs": 2})
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 19e"):
        create_env(config)


def _randomized(env):
    from rlx_tpu_torch.environments.wrappers import DomainRandomizationWrapper

    return DomainRandomizationWrapper(env, observation_noise_std=0.1, action_delay_chance=0.3)


@pytest.mark.parametrize("environment, overrides, wrap", [
    ("locomotion.ant.cuda", {"environment.initial_state_noise": 0.1, "environment.perturbation_chance": 0.5}, None),
    (PENDULUM, {}, None), (CARTPOLE, {}, None), (PENDULUM, {"environment.mask_velocity": True}, None),
    ("classic.pixel_grid.cuda", {}, None), ("classic.pixel_chase.cuda", {}, None), (PENDULUM, {}, _randomized),
    # the robot's every draw (terrain, randomization, commands, pushes,
    # noise, initial state; the soccer gait) per seed
    ("locomotion.robot.cuda", {"environment.terrain.type": "plane"}, None), ("locomotion.robot.cuda", {}, None),
    ("locomotion.soccer.cuda", {}, None),
])
def test_env_rows_of_a_seed_are_its_one_seed_env(environment, overrides, wrap):
    """An env of S * N envs reset with S seeds steps seed s's rows as the
    env of N envs reset with seed s's seed, under the same actions (the
    randomization wrapper's noise and delays included; the robot on its
    plane and its default heightfield, and soccer)."""
    seeded = lambda S: make_config("ppo.cuda", environment, **{
        **overrides, "runner.device": "cpu", "environment.nr_envs": 3, "algorithm.nr_parallel_seeds": S,
        "algorithm.logging_active": False})
    env, _ = create_env(seeded(2))
    single, _ = create_env(seeded(1))
    if wrap is not None:
        env, single = wrap(env), wrap(single)
    assert env.parallel_seeds
    seeds = [5, 9]
    state = env.reset(seeds)
    states = [single.reset(x) for x in seeds]
    assert torch.equal(state.observation, torch.cat([st.observation for st in states]))
    rng = np.random.default_rng(0)
    nr_actions = getattr(env.single_action_space, "n", None)
    # the plain engine is slow on the CPU: the Ant's 4 steps each draw
    # kicks, the robots' draw pushes and in-episode randomization
    locomotion = environment.startswith("locomotion.")
    for _ in range(4 if locomotion else 12):
        if nr_actions is not None:
            action = torch.tensor(rng.integers(0, nr_actions, size=6), dtype=torch.int32)
        else:
            action = torch.tensor(rng.uniform(-1, 1, size=(6,) + tuple(env.single_action_space.shape)),
                                  dtype=torch.float32)
        state = env.step(state, action)
        states = [single.step(st, action[3 * s:3 * s + 3]) for s, st in enumerate(states)]
        for field in ("observation", "reward", "terminated", "truncated"):
            # the plain engine solves its batch at once, so 6 envs and 3
            # round apart in the last bits, which the Ant's contacts amplify
            # over the steps (a draw of another seed's would be off by
            # ~0.1; the robots' rows stay within ~3e-7); the classic envs
            # are exact
            tol = (1e-4 if "ant" in environment else 1e-5) if locomotion else 0.0
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


def _perturbed(module, seed):
    """``module`` with every parameter and running statistic moved off its
    init, differently for each seed."""
    generator = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.mul_(1.0 + 0.5 * torch.rand(p.shape, generator=generator)).add_(0.1 * torch.randn(p.shape,
                                                                                                generator=generator))
        for name, buffer in running_buffers(module).items():
            if buffer.is_floating_point():
                buffer.copy_(torch.rand(buffer.shape, generator=generator) + (0.5 if name.endswith("var") else -0.5))
            else:
                buffer.fill_(999 + seed)   # BatchRenorm's steps: seeds 2 and up past the warmup of 1000
    return module


@pytest.mark.parametrize("layer", ["batch_renorm", "flashsac_batch_norm"])
def test_running_statistics_are_per_seed(layer):
    """A seed-stacked norm layer under ``ParallelSeeds.map`` gives each seed
    the output, batch statistics and running averages of its own module fed
    its own rows (train mode, then eval mode on the committed statistics);
    the seeds' rows differ in location and scale, so statistics over the
    folded ``S * B`` rows would fail the comparison."""
    import copy

    from rlx_tpu_torch.algorithms.flashsac.cuda.layers import BatchNorm
    from rlx_tpu_torch.algorithms.parallel_seeds import ParallelSeeds, stack_modules
    from rlx_tpu_torch.models.layers import BatchRenorm, commit_batch_stats

    S, B, F = 3, 16, 5
    make = {"batch_renorm": lambda: BatchRenorm(F, nr=2), "flashsac_batch_norm": lambda: BatchNorm(F, nr=2)}[layer]
    singles = [_perturbed(make(), s) for s in range(S)]
    stacked = stack_modules([copy.deepcopy(m) for m in singles])
    P = ParallelSeeds(0, S, "cpu")
    generator = torch.Generator().manual_seed(1)
    for step in range(3):
        x = torch.randn(S, B, F, generator=generator) * torch.tensor([1.0, 4.0, 0.5])[:, None, None] \
            + torch.tensor([0.0, 3.0, -2.0])[:, None, None]
        train = step < 2
        out = P.map(lambda rows: stacked(rows, train), {"norm": stacked}, x)
        if train:
            assert stacked.pending[0].shape == (S, 2, F)
            folded = x.reshape(S * B, F).mean(0)
            assert not any(torch.allclose(stacked.pending[0][s], folded.expand(2, F), atol=1e-3) for s in range(S))
            commit_batch_stats(stacked)
        for s, single in enumerate(singles):
            ref = single(x[s], train)
            if train:
                commit_batch_stats(single)
            torch.testing.assert_close(out[s], ref, rtol=1e-6, atol=1e-6, msg=lambda m: f"{step} seed {s}: {m}")
            for name, buffer in running_buffers(single).items():
                torch.testing.assert_close(running_buffers(stacked)[name][s], buffer, rtol=1e-6, atol=1e-6,
                                           msg=lambda m: f"{step} seed {s} {name}: {m}")


@pytest.mark.parametrize("family", ["xqc", "simbav2", "flashsac"])
def test_post_step_projections_keep_each_seed(family):
    """The weight-norm projection (XQC, SimbaV2) and FlashSAC's
    ``project_params`` normalize over the last axis, so on seed-stacked nets
    they give each seed its own net's projection."""
    import copy

    from rlx_tpu_torch.algorithms.flashsac.cuda import layers as flashsac_layers
    from rlx_tpu_torch.algorithms.parallel_seeds import stack_modules
    from rlx_tpu_torch.algorithms.simbav2.cuda.simbav2 import SimbaV2Policy, SimbaV2VectorCritic
    from rlx_tpu_torch.algorithms.xqc.cuda.xqc import XQCPolicy, XQCVectorCritic
    from rlx_tpu_torch.models.weight_norm import weight_norm_

    nets = {
        "xqc": (lambda: XQCPolicy(3, 2, 8, 1), lambda: XQCVectorCritic(3, 2, 8, 1, 5)),
        "simbav2": (lambda: SimbaV2Policy(3, 2, 8, 1), lambda: SimbaV2VectorCritic(3, 2, 8, 1, 5)),
        "flashsac": (lambda: flashsac_layers.FlashSACPolicy(3, 2, 8, 1),
                     lambda: flashsac_layers.FlashSACDoubleCritic(3, 2, 8, 1, 5, -1.0, 1.0)),
    }[family]
    for s_make, make in enumerate(nets):
        singles = [_perturbed(make(), 10 * s_make + s) for s in range(3)]
        stacked = stack_modules([copy.deepcopy(m) for m in singles])
        for module in singles + [stacked]:
            if family == "flashsac":
                flashsac_layers.project_params(module)
            else:
                weight_norm_(module.hidden_layers(), module.predictor_layers(), True)
        for s, single in enumerate(singles):
            for name, p in single.named_parameters():
                torch.testing.assert_close(dict(stacked.named_parameters())[name][s], p, rtol=1e-6, atol=1e-7,
                                           msg=lambda m: f"{family} seed {s} {name}: {m}")
