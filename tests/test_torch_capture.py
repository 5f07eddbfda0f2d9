"""The learning iteration that a CUDA graph captures, checked on the CPU:

- (a) no host read: for every registration that captures (PPO on the Ant,
  discrete PPO on CartPole, ESPO, PPO-DTRL, PPO over an observation window
  and PPO with memory actions; PPO-LSTM, -GRU, -Mamba-2 and -transformer on
  the masked Pendulum, REPPO on the Ant and on Pendulum, PQN on CartPole;
  PPO and REPPO on the robot's plane, PPO-LSTM on its default heightfield
  and on soccer; FastTD3 on the Ant, and FastTD3, FastSAC, SAC, TD3 and
  DDPG on Pendulum, whose learning iteration is one learning step on the
  model's prefilled replay buffer, with logging on), one learning
  iteration after a warm-up iteration runs
  under ``torch_parity.NoHostRead``, a dispatch mode that raises on
  ``aten._local_scalar_dense`` (``.item()``, ``float()``, ``bool()`` of a
  tensor) and on ``aten.lift_fresh`` (a tensor made from host data, which
  a graph would freeze at its capture value), with ``torch.Generator``
  refusing to make a new generator (the physics engine's eager path, which
  these CPU iterations run, keeps its constants on the device); the env
  state's ``map_tensors`` / ``copy_`` and the carry's ``copy_carry_`` round trip
  (the recurrent policy's carry, PQN's update step, the off-policy
  learning-step count) that ends a captured iteration;
- (b) no rebinding: every tensor the model holds (the nets' parameters,
  Adam's state, REPPO's normalizer and old-policy snapshot, the device
  counts and rates; the off-policy targets, normalizer and metric sums, and
  the replay buffer's storage, write head and fill) is the same tensor, at
  the same address, after an eager iteration as before it, for every
  registration that captures;
- (c) ESPO's branchless stop against the JAX package's ESPO: parameters,
  Adam's moments and step counts, ``nr_active_epochs`` and every metric,
  with the stop firing in the second epoch (f32 on both sides, 1e-5, as
  the ESPO test of ``test_torch_ppo_variants.py``);
- (d) the learning-rate schedule on the device for PPO, the recurrent PPO
  and PQN against ``learning_rate_at`` (exactly: the same float64
  arithmetic) and against the JAX package's optax schedule (f32 rounding,
  1e-7 relative), over two iterations' worth of updates with annealing
  on, and through two learning iterations; PQN's device epsilon against
  JAX's ``PQN.epsilon`` and its restart at every ``train()`` call;
- (e) the selection rule (``capture_choice``) on stub models on
  ``torch.device("cuda")``, which needs no card: capture for the sixteen
  registrations on the Ant, CartPole and Pendulum (wrapped or not)
  and for the robot and soccer envs, wrapped or not; eager with its reason
  for a dp or tp mesh, parallel seeds or the CPU (on the Ant and on the
  robot), a host env, the pixel envs, an algorithm without a captured
  iteration (a SAC subclass that does not capture among them);
- (f) the off-policy parts a captured learning step needs: the TD3
  family's branchless policy delay against the eager branch it replaced,
  and FastSAC's and SAC's device learning rate against the host schedule
  (``test_torch_replay_buffer.py`` holds the device write head and fill,
  ``test_torch_train_state.py`` the device Adam / AdamW step).

The capture itself runs only on the card: ``chip_smoke.py`` phases 48-51.
"""

import types

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from rlx_tpu_torch import convert
from rlx_tpu_torch.algorithms.training_program import capture_choice, copy_carry_, model_tensors
from rlx_tpu_torch.config import create_model, make_config
from rlx_tpu_torch.environments.env import EnvState
from torch_parity import NoHostRead, close, np_tree
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

NETS = {"algorithm.policy_hidden_sizes": (16, 16), "algorithm.critic_hidden_sizes": (16, 16),
        "algorithm.activation": "elu", "algorithm.layer_norm": True, "algorithm.logging_active": False,
        "algorithm.evaluation_active": False, "runner.device": "cpu"}


PPO_SIZES = {**NETS, "environment.nr_envs": 4, "algorithm.nr_steps": 4, "algorithm.minibatch_size": 8,
             "algorithm.nr_epochs": 2, "algorithm.total_timesteps": 64, "environment.horizon": 3}
ON_POLICY = {"algorithm.logging_active": False, "algorithm.evaluation_active": False, "runner.device": "cpu",
             "environment.nr_envs": 4, "algorithm.nr_steps": 4, "algorithm.nr_minibatches": 2,
             "algorithm.nr_epochs": 2, "algorithm.total_timesteps": 64, "environment.horizon": 3}
RECURRENT = {**ON_POLICY, "environment.mask_velocity": True, "algorithm.obs_encoding_dim": 8,
             "algorithm.rnn_hidden_dim": 4, "algorithm.critic_hidden_sizes": (16, 16)}
# the robot envs (no horizon or velocity mask: an episode is 20 s)
ROBOT = {k: v for k, v in ON_POLICY.items() if k != "environment.horizon"}
ROBOT_RECURRENT = {k: v for k, v in RECURRENT.items() if k not in ("environment.horizon", "environment.mask_velocity")}
PLANE = {"environment.terrain.type": "plane"}
REGISTRATIONS = {
    "ppo on the Ant": ("ppo", "locomotion.ant", PPO_SIZES),
    "discrete ppo on CartPole": ("ppo", "classic.cart_pole", PPO_SIZES),
    "espo": ("espo", "classic.pendulum", {**PPO_SIZES, "algorithm.nr_epochs": 3}),
    "ppo_dtrl": ("ppo_dtrl", "classic.pendulum", PPO_SIZES),
    "ppo_history_window": ("ppo_history_window", "classic.pendulum", {**PPO_SIZES, "environment.mask_velocity": True}),
    "ppo_memory_actions": ("ppo_memory_actions", "classic.pendulum", {**PPO_SIZES, "environment.mask_velocity": True}),
    "ppo_lstm": ("ppo_lstm", "classic.pendulum", RECURRENT),
    "ppo_gru": ("ppo_gru", "classic.pendulum", RECURRENT),
    "ppo_mamba2": ("ppo_mamba2", "classic.pendulum",
                   {**RECURRENT, "algorithm.cell_state_dim": 4, "algorithm.cell_conv_kernel": 3}),
    "ppo_transformer": ("ppo_transformer", "classic.pendulum",
                        {**RECURRENT, "algorithm.tf_context_len": 4, "algorithm.tf_nr_heads": 2,
                         "algorithm.tf_nr_blocks": 2}),
    "reppo on the Ant": ("reppo", "locomotion.ant",
                         {**ON_POLICY, "algorithm.policy_hidden_dim": 16, "algorithm.critic_hidden_dim": 16}),
    # REPPO where no physics makes host constants: its own ops are held too
    "reppo on Pendulum": ("reppo", "classic.pendulum",
                          {**ON_POLICY, "algorithm.policy_hidden_dim": 16, "algorithm.critic_hidden_dim": 16}),
    "pqn on CartPole": ("pqn", "classic.cart_pole", {**ON_POLICY, "algorithm.critic_hidden_sizes": (16, 16)}),
    "ppo on the robot plane": ("ppo", "locomotion.robot",
                               {**{k: v for k, v in PPO_SIZES.items() if k != "environment.horizon"},
                                "algorithm.nr_steps": 2, **PLANE}),
    "ppo_lstm on the robot heightfield": ("ppo_lstm", "locomotion.robot", {**ROBOT_RECURRENT, "algorithm.nr_steps": 2}),
    "ppo_lstm on soccer": ("ppo_lstm", "locomotion.soccer", {**ROBOT_RECURRENT, "algorithm.nr_steps": 2}),
    "reppo on the robot plane": ("reppo", "locomotion.robot",
                                 {**ROBOT, "algorithm.nr_steps": 2, "algorithm.policy_hidden_dim": 16,
                                  "algorithm.critic_hidden_dim": 16, **PLANE}),
}
# the off-policy families that capture: a learning iteration is one learning
# step on the model's replay buffer (16 prefill rows, batch 16), logging on
OFF_POLICY = {**NETS, "algorithm.logging_active": True, "environment.nr_envs": 4, "algorithm.batch_size": 16,
              "algorithm.learning_starts": 16, "algorithm.buffer_size": 256, "algorithm.total_timesteps": 256}
OFF_POLICY_REGISTRATIONS = {
    "fasttd3 on the Ant": ("fasttd3", "locomotion.ant", {**OFF_POLICY, "algorithm.n_step": 3}),
    **{f"{algorithm} on Pendulum": (algorithm, "classic.pendulum", OFF_POLICY)
       for algorithm in ("fasttd3", "fastsac", "sac", "td3", "ddpg")},
}
REGISTRATIONS.update(OFF_POLICY_REGISTRATIONS)


def _registration(name):
    algorithm, environment, overrides = REGISTRATIONS[name]
    return create_model(make_config(f"{algorithm}.cuda", f"{environment}.cuda", **overrides))


def _initial_carry(model):
    """The rest of a ``train()`` call's device carry at its start: the
    recurrent policy's zero carry, PQN's update step 0, an off-policy
    family's learning-step count, or nothing.  An off-policy model first
    gets its replay buffer and prefill (``_init_train_carry``), and its
    count is a device tensor, as a captured step holds it (the eager loop
    counts on the host), from 1: the warm-up is step 1 and the checked
    iteration step 2, one where the TD3 family's delayed policy steps too."""
    if hasattr(model, "policy_carry"):
        return (model.policy.initialize_carry(model.nr_envs),)
    if hasattr(model, "buffer"):
        model._init_train_carry()
        return (torch.ones((), dtype=torch.int64),)
    if hasattr(model, "epsilon"):
        return (torch.zeros((), dtype=torch.int64),)
    return ()


def _optimizers(model):
    """Every optimizer the model holds, a ``TrainState``'s too."""
    for value in vars(model).values():
        optimizer = value if isinstance(value, torch.optim.Optimizer) else getattr(value, "optimizer", None)
        if isinstance(optimizer, torch.optim.Optimizer):
            yield optimizer


def _adam_steps(model):
    """Each optimizer's step count (of its first parameter with a state)."""
    out = []
    for optimizer in _optimizers(model):
        out += [int(state["step"]) for state in optimizer.state.values()][:1]
    return out


@pytest.mark.parametrize("name", list(REGISTRATIONS))
def test_learning_iteration_reads_nothing_back(name):
    model = _registration(name)
    state, *carry, _ = model.learning_iteration(model.train_env.reset(0), *_initial_carry(model))   # the warm-up
    steps = _adam_steps(model)
    static = state.map_tensors(torch.clone)
    static_carry = pytree.tree_map(torch.clone, tuple(carry))
    generators = static.generators()
    assert len(generators) == 1 and generators[0] is state.generator
    with NoHostRead():
        new_state, *new_carry, metrics = model.learning_iteration(static, *static_carry)
        copy_carry_(static_carry, tuple(new_carry))       # how a captured iteration ends
        static.copy_(new_state)
    assert steps and all(after > before for after, before in zip(_adam_steps(model), steps))
    assert all(torch.isfinite(v).all() for v in metrics.values())
    ours, refs = (pytree.tree_leaves([getattr(s, f) for f in EnvState.TENSOR_FIELDS]) for s in (static, new_state))
    assert len(ours) == len(refs) > 6
    for mine, ref in zip(ours, refs):
        assert mine is not ref and torch.equal(mine, ref)
    ours, refs = pytree.tree_leaves(static_carry), pytree.tree_leaves(tuple(new_carry))
    assert len(ours) == len(refs) == len(pytree.tree_leaves(carry))
    for mine, ref in zip(ours, refs):
        assert mine is not ref and torch.equal(mine, ref)
    if name == "pqn on CartPole":
        assert int(static_carry[0]) == 2
    if name in OFF_POLICY_REGISTRATIONS:
        assert int(static_carry[0]) == 3 and model.initial_step(3) == 3   # the CPU's eager loop counts on the host
        assert len(steps) == len(model.state_names) - ("obs_normalizer" in model.state_names)
        assert set(model.metric_sums) >= set(metrics) and all(torch.isfinite(v) for v in model.metric_sums.values())


@pytest.mark.parametrize("name", list(REGISTRATIONS))
def test_learning_iteration_rebinds_no_model_state(name):
    """A graph reads and writes the tensors it was captured with: a model
    that binds an attribute to a new tensor inside its iteration (a
    normalizer's update returning a fresh dict, a deep copy of the policy)
    would have every replay read the tensors of the capture."""
    model = _registration(name)
    state, *carry, _ = model.learning_iteration(model.train_env.reset(0), *_initial_carry(model))   # the warm-up
    before = model_tensors(model)
    model.learning_iteration(state, *carry)
    after = model_tensors(model)
    assert set(after) == set(before) and any("optimizer" in k for k in before)
    rebound = [k for k in before if after[k] is not before[k] or after[k].data_ptr() != before[k].data_ptr()]
    assert not rebound, rebound
    if name == "reppo on the Ant":
        assert "obs_normalizer.mean" in before and any(k.startswith("old_policy.") for k in before)
    if name in OFF_POLICY_REGISTRATIONS:
        assert {"buffer.storage", "buffer.pos", "buffer.size"} <= set(before)
        assert any(k.startswith("metric_sums.") for k in before)
        for state_name in model.state_names:
            state = getattr(model, state_name)
            if state_name == "obs_normalizer":
                assert {"obs_normalizer.mean", "obs_normalizer.var", "obs_normalizer.count"} <= set(before)
                continue
            assert f"{state_name}.optimizer.0.exp_avg" in before and f"{state_name}.optimizer.0.step" in before
            if state.target is not None:
                assert any(k.startswith(f"{state_name}.target.") for k in before)


def test_state_copy_refuses_another_structure():
    model = create_model(make_config("ppo.cuda", "classic.pendulum.cuda", **NETS))
    state = model.train_env.reset(0)
    with pytest.raises(ValueError, match="structure"):
        state.copy_(state.replace(info={}))
    with pytest.raises(ValueError, match="cannot take the place"):
        state.copy_(state.map_tensors(lambda t: t.double() if t.is_floating_point() else t))
    carry = (torch.zeros(4, 3), torch.zeros(4, 3))
    with pytest.raises(ValueError, match="structure"):
        copy_carry_(carry, (torch.zeros(4, 3),))
    with pytest.raises(ValueError, match="structure"):
        copy_carry_((carry,), ([*carry],))
    with pytest.raises(ValueError, match="cannot take the place"):
        copy_carry_(carry, (torch.zeros(4, 3), torch.zeros(4, 3, dtype=torch.float64)))
    # a source that is one of the destinations is read before any is written
    a, b = torch.ones(2), torch.full((2,), 2.0)
    copy_carry_((a, b), (b, a))
    assert a.tolist() == [2.0, 2.0] and b.tolist() == [1.0, 1.0]


def _adam_nodes(opt_state):
    """The Adam state (``mu``, ``nu``, ``count``) inside an optax state."""
    import jax

    return [node for node in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "nu")) if hasattr(node, "nu")][0]


@pytest.mark.parametrize("operator", ["mean", "median"])
def test_branchless_espo_matches_jax(operator):
    """``max_ratio_delta`` 1e-3 lets epochs 0 and 1 step (epoch 0's ratio
    is exactly 1) and stops epochs 2-5 with a device flag: the parameters,
    both moments and the counts must be the JAX package's, whose scan
    selects the whole train state by ``active``."""
    import jax

    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config

    N = 32
    shared = {"environment.nr_envs": 4, "algorithm.nr_steps": 8, "algorithm.minibatch_size": N,
              "algorithm.nr_epochs": 6, "algorithm.total_timesteps": 4 * N, "algorithm.max_ratio_delta": 1e-3,
              "algorithm.delta_calc_operator": operator, "algorithm.learning_rate": 1e-2,
              **{k: v for k, v in NETS.items() if k != "runner.device"}}
    jmodel = jax_create_model(jax_make_config("espo.tpu", "locomotion.ant.tpu", **shared, **{"runner.mesh_dp": 1}))
    model = create_model(make_config("espo.cuda", "locomotion.ant.cuda", **shared, **{"runner.device": "cpu"}))
    model.policy.module.load_state_dict(convert.policy_state_dict(np_tree(jmodel.policy_state.params)))
    model.critic.load_state_dict(convert.critic_state_dict(np_tree(jmodel.critic_state.params)))
    rng = np.random.default_rng(5)
    batch = [rng.normal(size=(N, 34)).astype(np.float32), rng.normal(size=(N, 8)).astype(np.float32),
             None, rng.normal(size=N).astype(np.float32), rng.normal(size=N).astype(np.float32)]
    batch[2] = model.policy.log_prob_entropy(torch.tensor(batch[0]), torch.tensor(batch[1]))[0].detach().numpy()
    policy_state, critic_state, jmetrics = jax.jit(jmodel._optimize)(
        jmodel.policy_state, jmodel.critic_state, tuple(batch), jax.random.PRNGKey(0))
    batch = tuple(torch.tensor(x) for x in batch)
    with NoHostRead():
        metrics = model._optimize(batch)
    assert float(metrics["policy_ratio/nr_active_epochs"]) == float(jmetrics["policy_ratio/nr_active_epochs"]) == 2.0
    for k in jmetrics:
        close(float(metrics[k]), float(jmetrics[k]), 1e-5, k)
    for module, optimizer, state, to_torch in (
            (model.policy.module, model.policy_optimizer, policy_state, convert.policy_state_dict),
            (model.critic, model.critic_optimizer, critic_state, convert.critic_state_dict)):
        adam = _adam_nodes(state.opt_state)
        refs = {"params": to_torch(np_tree(state.params)), "exp_avg": to_torch(np_tree(adam.mu)),
                "exp_avg_sq": to_torch(np_tree(adam.nu))}
        for name, p in module.named_parameters():
            close(p, refs["params"][name], 1e-5, f"{name}")
            for key in ("exp_avg", "exp_avg_sq"):
                close(optimizer.state[p][key], refs[key][name], 1e-5, f"{name} {key}")
            assert float(optimizer.state[p]["step"]) == int(adam.count) == 2
    assert model.nr_optimizer_steps == 2


SCHEDULES = {   # name: (algorithm, environment, the sizes, the JAX model's tx)
    "ppo": ("ppo", "classic.pendulum", {"algorithm.minibatch_size": 4,
                                        **{k: v for k, v in NETS.items() if k != "runner.device"}},
            lambda jmodel: jmodel.policy_state.tx),
    "ppo_lstm": ("ppo_lstm", "classic.pendulum", {"algorithm.nr_minibatches": 4, "algorithm.rnn_hidden_dim": 4,
                                                  "algorithm.obs_encoding_dim": 8,
                                                  "algorithm.critic_hidden_sizes": (16, 16)},
                 lambda jmodel: jmodel.policy_state.tx),
    "pqn": ("pqn", "classic.cart_pole", {"algorithm.nr_minibatches": 4, "algorithm.critic_hidden_sizes": (16, 16)},
            lambda jmodel: jmodel.critic_state.tx),
}


def _jax_model(algorithm, environment, overrides):
    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config

    return jax_create_model(jax_make_config(f"{algorithm}.tpu", f"{environment}.tpu", **overrides,
                                            **{"runner.mesh_dp": 1}))


def test_device_learning_rate_schedule():
    """Two learning iterations of 2 epochs x 4 minibatches over a run of 4
    updates: the rate anneals from 3e-4 by a quarter an iteration."""
    _check_device_schedule("ppo")


@pytest.mark.parametrize("name", ["ppo_lstm", "pqn"])
def test_recurrent_and_pqn_device_learning_rate_schedules(name):
    """As PPO's, for the recurrent PPO's and PQN's schedules (the same
    ``train_state.DeviceStepSchedule``)."""
    _check_device_schedule(name)


def _check_device_schedule(name):
    import optax

    algorithm, environment, sizes, jax_tx = SCHEDULES[name]
    shared = {"environment.nr_envs": 4, "algorithm.nr_steps": 4, "algorithm.nr_epochs": 2,
              "algorithm.total_timesteps": 4 * 16, "algorithm.anneal_learning_rate": True,
              "algorithm.logging_active": False, "algorithm.evaluation_active": False, **sizes}
    model = create_model(make_config(f"{algorithm}.cuda", f"{environment}.cuda", **shared,
                                     **{"runner.device": "cpu"}))
    jmodel = _jax_model(algorithm, environment, shared)
    per_update = model.nr_minibatches * model.nr_epochs
    assert per_update == 8 and model.nr_updates == 4
    tx = jax_tx(jmodel)
    params = (jmodel.critic_state if name == "pqn" else jmodel.policy_state).params
    opt_state = tx.init(params)
    zeros = optax.tree_utils.tree_zeros_like(params)
    for count in range(2 * per_update + 1):
        rate = model.learning_rate_tensor(torch.tensor(count))
        assert rate.dtype == torch.float64 and float(rate) == model.learning_rate_at(count)
        _, opt_state = tx.update(zeros, opt_state, params)
        close(float(rate), float(opt_state[1].hyperparams["learning_rate"]), 1e-7, f"count {count}")
    state, carry = model.train_env.reset(0), _initial_carry(model)
    for iteration in (1, 2):
        state, *carry, metrics = model.learning_iteration(state, *carry)
        assert model.nr_optimizer_steps == iteration * per_update
        assert float(metrics["lr/learning_rate"]) == pytest.approx(
            model.learning_rate * (1.0 - (iteration - 1) / 4), rel=1e-6)


def test_pqn_device_epsilon_matches_jax_and_restarts():
    """PQN's epsilon from its device update step: JAX's ``PQN.epsilon`` in
    f32 over counts 0 ... decay + 2, and every ``train()`` call starts
    again at epsilon_start, as JAX's ``outer_step * n + step``."""
    shared = {**REGISTRATIONS["pqn on CartPole"][2], "algorithm.epsilon_decay_fraction": 0.5,
              "algorithm.logging_active": True, "algorithm.total_timesteps": 4 * 16 * 2}
    shared.pop("runner.device")
    model = create_model(make_config("pqn.cuda", "classic.cart_pole.cuda", **shared, **{"runner.device": "cpu"}))
    jmodel = _jax_model("pqn", "classic.cart_pole", shared)
    decay = model.epsilon_decay_updates
    assert decay == jmodel.epsilon_decay_updates == 4
    for count in range(decay + 3):
        ours = model.epsilon(torch.tensor(count))
        assert ours.dtype == torch.float32 and ours.shape == ()
        assert float(ours) == float(np.float32(jmodel.epsilon(count))), count
    calls = []
    for _ in range(2):
        model.train()
        calls.append([m["epsilon/epsilon"] for m in model.metrics_history[-model.nr_updates:]])
    assert calls[0] == calls[1] and len(calls[0]) == model.nr_updates == 8
    assert calls[0][0] == float(np.float32(model.epsilon_start))
    assert calls[0][-1] == pytest.approx(model.epsilon_end, abs=1e-6)


def _stub(cls, env, device="cuda", dp=1, tp=1, parallel=None):
    model = object.__new__(cls)
    model.device = torch.device(device)
    model.mesh = types.SimpleNamespace(dp=dp, tp=tp)
    model.parallel = parallel
    model.train_env = env
    return model


def _env_classes():
    from rlx_tpu_torch.environments.classic.cart_pole.cuda.environment import CartPole
    from rlx_tpu_torch.environments.classic.pendulum.cuda.environment import Pendulum
    from rlx_tpu_torch.environments.classic.pixel_chase.cuda.environment import PixelChase
    from rlx_tpu_torch.environments.classic.pixel_grid.cuda.environment import PixelGrid
    from rlx_tpu_torch.environments.gym.host_bridge import HostEnv
    from rlx_tpu_torch.environments.locomotion.ant.cuda.environment import Ant
    from rlx_tpu_torch.environments.locomotion.robot.cuda.environment import LocomotionEnv
    from rlx_tpu_torch.environments.locomotion.soccer.cuda.environment import SoccerEnv
    from rlx_tpu_torch.environments.native.batcher import NativeEnvBatch

    return dict(Ant=Ant, CartPole=CartPole, Pendulum=Pendulum, PixelChase=PixelChase, PixelGrid=PixelGrid,
                HostEnv=HostEnv, NativeEnvBatch=NativeEnvBatch, LocomotionEnv=LocomotionEnv, SoccerEnv=SoccerEnv)


def _algorithm_class(name):
    from rlx_tpu_torch.algorithms import algorithm_manager
    from rlx_tpu_torch.config import import_for

    import_for("algorithms", f"{name}.cuda")
    return algorithm_manager.get_algorithm_model_class(f"{name}.cuda")()


CAPTURING = ["ppo", "espo", "ppo_dtrl", "ppo_history_window", "ppo_memory_actions",
             "ppo_lstm", "ppo_gru", "ppo_mamba2", "ppo_transformer", "reppo", "pqn",
             "fasttd3", "fastsac", "sac", "td3", "ddpg"]


@pytest.mark.parametrize("algorithm", CAPTURING)
def test_capture_choice_takes_the_slice(algorithm):
    from rlx_tpu_torch.environments.classic.pendulum.cuda.environment import Pendulum
    from rlx_tpu_torch.environments.wrappers import (
        DomainRandomizationWrapper, MemoryActionsWrapper, ObservationMaskWrapper, ObservationWindowWrapper,
    )

    cls = _algorithm_class(algorithm)
    pendulum = Pendulum(4, device="cpu")
    classes = _env_classes()
    # a wrapped robot: the wrapper passes on the inner env's answer
    window = object.__new__(ObservationWindowWrapper)
    window.env = object.__new__(classes["LocomotionEnv"])
    envs = [object.__new__(classes[name]) for name in ("Ant", "CartPole", "Pendulum", "LocomotionEnv", "SoccerEnv")] + [
        ObservationMaskWrapper(pendulum, [0, 1]), ObservationWindowWrapper(ObservationMaskWrapper(pendulum, [0, 1]), 3),
        MemoryActionsWrapper(pendulum, 2), DomainRandomizationWrapper(pendulum, 0.1, 0.1), window]
    for env in envs:
        capture, reason = capture_choice(_stub(cls, env))
        assert capture, (type(env).__name__, reason)
        assert type(env).__name__ in reason and cls.__name__ in reason


def test_capture_choice_runs_everything_else_eagerly():
    envs = _env_classes()
    ppo = _algorithm_class("ppo")
    ant = object.__new__(envs["Ant"])
    cases = {
        "the CPU": (_stub(ppo, ant, device="cpu"), "only a CUDA device"),
        "a dp mesh": (_stub(ppo, ant, dp=2), "dp = 2"),
        "a tp mesh": (_stub(ppo, ant, tp=2), "tp = 2"),
        "parallel seeds": (_stub(ppo, ant, parallel=types.SimpleNamespace(nr_seeds=4)), "4 parallel seeds"),
        "an algorithm without it": (_stub(_algorithm_class("dqn"), ant), "DQN has no captured"),
        "an off-policy family": (_stub(_algorithm_class("mpo"), ant), "MPO has no captured"),
        # SAC captures, its subclasses that do not declare False
        **{f"SAC's subclass {name}": (_stub(_algorithm_class(name), ant), f"{cls} has no captured")
           for name, cls in (("flashsac", "FlashSAC"), ("redq", "REDQ"), ("simbav2", "SimbaV2"))},
    }
    # the robot and soccer envs capture, but not on the CPU, a mesh or with
    # parallel seeds
    ppo_lstm = _algorithm_class("ppo_lstm")
    for name in ("LocomotionEnv", "SoccerEnv"):
        robot = object.__new__(envs[name])
        cases[f"the CPU on {name}"] = (_stub(ppo_lstm, robot, device="cpu"), "only a CUDA device")
        cases[f"a dp mesh on {name}"] = (_stub(ppo_lstm, robot, dp=2), "dp = 2")
        cases[f"a tp mesh on {name}"] = (_stub(ppo_lstm, robot, tp=2), "tp = 2")
        cases[f"parallel seeds on {name}"] = (_stub(ppo_lstm, robot, parallel=types.SimpleNamespace(nr_seeds=4)),
                                              "4 parallel seeds")
        cases[f"FlashSAC on {name}"] = (_stub(_algorithm_class("flashsac"), robot), "FlashSAC has no captured")
    for algorithm in CAPTURING:
        cls = _algorithm_class(algorithm)
        for name in ("HostEnv", "NativeEnvBatch", "PixelChase", "PixelGrid"):
            env = object.__new__(envs[name])
            cases[f"{algorithm} on {name}"] = (_stub(cls, env), f"the env {name} does not declare capture")
    for what, (model, reason) in cases.items():
        capture, why = capture_choice(model)
        assert not capture and reason in why, (what, why)


@pytest.mark.parametrize("algorithm", ["fasttd3", "td3"])
def test_branchless_policy_delay_is_the_eager_branch(algorithm):
    """Four updates at delay 2 from the device learning-step count (a
    captured step's): the policy's Adam count reaches 2, the policy, its
    Adam state and both targets move only on the even steps, and every
    tensor equals, bit for bit, the same updates from the host count,
    which branch on the host as the eager loop does."""
    overrides = {**OFF_POLICY, "algorithm.policy_delay": 2}
    if algorithm == "fasttd3":
        overrides = {**OFF_POLICY, "algorithm.n_step": 1, "algorithm.nr_critic_updates_per_policy_update": 2}
    select, branch = (create_model(make_config(f"{algorithm}.cuda", "classic.pendulum.cuda", **overrides))
                      for _ in range(2))
    rng = np.random.default_rng(7)
    moved_at = []
    for step in range(4):
        batch = {"observation": rng.normal(size=(16, 3)), "next_observation": rng.normal(size=(16, 3)),
                 "action": rng.uniform(-1, 1, size=(16, 1)), "reward": rng.normal(size=16),
                 "terminated": (rng.random(16) < 0.2).astype(np.float64)}
        batch = {k: torch.tensor(v, dtype=torch.float32) for k, v in batch.items()}
        noise = torch.tensor(rng.normal(size=(16, 1)), dtype=torch.float32)
        before = {k: v.clone() for k, v in model_tensors(select).items()}
        count = torch.full((), step, dtype=torch.int64)   # a captured step's count
        with NoHostRead():
            select.update(batch, count, smoothing_noise=noise)
        branch.update(batch, step, smoothing_noise=noise)
        after = model_tensors(select)
        for k, v in model_tensors(branch).items():
            assert torch.equal(after[k], v), (step, k)
        delayed = [k for k in after if k.startswith(("policy.", "critic.target."))]
        moved = {k for k in delayed if k not in before or not torch.equal(after[k], before[k])}
        moved_at.append(bool(moved))
        assert not moved or {k for k in delayed if k.startswith(("policy.target.", "critic.target."))} <= moved
        critic = [k for k in after if k.startswith("critic.") and not k.startswith(("critic.target.", "critic.optimizer."))]
        assert critic and all(k not in before or not torch.equal(after[k], before[k]) for k in critic), step
    assert moved_at == [True, False, True, False]
    assert select.policy.step_count() == 2 and select.critic.step_count() == 4


@pytest.mark.parametrize("algorithm", ["sac", "fastsac"])
def test_device_learning_rate_is_the_host_schedule(algorithm):
    """SAC's and FastSAC's rate from Adam's device count equals
    ``learning_rate_at`` of the host count exactly (the same float64
    arithmetic), annealed and constant, and a learning iteration's
    ``lr/learning_rate`` metric is its float32."""
    overrides = {**OFF_POLICY, "algorithm.anneal_learning_rate": True, "algorithm.total_timesteps": 4 * 64}
    model = create_model(make_config(f"{algorithm}.cuda", "classic.pendulum.cuda", **overrides))
    assert model.learning_rate_tensor().dtype == torch.float64
    assert float(model.learning_rate_tensor()) == model.learning_rate_at(0)
    state, *carry = model.train_env.reset(0), *_initial_carry(model)
    rates = []
    for _ in range(3):
        rates.append(model.learning_rate_at(model.policy.step_count()))
        state, *carry, metrics = model.learning_iteration(state, *carry)
        assert float(metrics["lr/learning_rate"]) == float(np.float32(rates[-1]))
    assert rates[0] > rates[1] > rates[2]
    for count in (0, 1, 17, 63):
        model.policy.optimizer.state[next(model.policy.module.parameters())]["step"].fill_(count)
        assert float(model.learning_rate_tensor()) == model.learning_rate_at(count), count
    model.anneal_learning_rate = False
    assert float(model.learning_rate_tensor()) == model.learning_rate_at(63) == model.learning_rate
