"""Parallel seeds on the port's robot env (``locomotion.robot.cuda``):

- the per-seed draws: seed s's rows of every draw are its one-seed draws,
  its bounds included;
- the 2-seed env against the JAX package's env ``vmap``ped over two keys,
  quadruped on the plane, 2 seeds x 2 envs, the reset and 2 steps in
  float64 on both sides: each seed's slice of every JAX draw is replayed
  into the port's env of 4 envs through ``SeedDraws`` (the steps from
  JAX's reset pose, whose float32 rounding decides a first contact), and the
  observation, reward, flags, info, episode store and the whole physics
  state (pose, velocities, anchors and every internal entry: randomization,
  commands, curriculum) agree at rtol=atol=1e-5;
- a 2-seed PPO-LSTM iteration and evaluation (episodes of 16 control
  steps) on the plane robot on the CPU: seed 1's parameters and ``eval_history`` row
  (``eval/episode_tracking`` among them) equal the one-seed run at
  ``seed_for(seed, 1)``, at the tolerances of ``test_torch_parallel_seeds.py``
  (1e-5 on the parameters, 1e-4 on the evaluations; float64, as its CrossQ
  case), and the asymmetric observation indices stay one buffer shared by
  the seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rlx_tpu_torch.algorithms.parallel_seeds import seed_for
from rlx_tpu_torch.config import create_env, create_model, make_config
from rlx_tpu_torch.environments.locomotion.robot.cuda.default_config import get_config
from rlx_tpu_torch.environments.locomotion.robot.cuda.draws import GeneratorDraws, SeedDraws
from rlx_tpu_torch.environments.locomotion.robot.cuda.environment import LocomotionEnv
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)
from torch_robot_parity import close_env_state, close_tree, configs, port_state, record_draws, replay, to64
from torch_robot_parity import float64  # noqa: F401 (module fixture: float64 on both sides)

S, N = 2, 2
TOL = 1e-5


def _fold(tree):
    """A ``vmap``ped JAX tree ``[S, N, ...]`` as one batch ``[S * N, ...]``."""
    return jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:]) if a.ndim >= 2 else a, tree)


def _seed_draws(draws):
    """Seed s's slice of every ``vmap``ped JAX draw, replayed per seed."""
    return SeedDraws([replay([np.asarray(d)[s] for d in draws]) for s in range(S)])


def test_per_seed_draws_are_each_seeds_one_seed_draws():
    """``GeneratorDraws`` over S generators and ``SeedDraws`` over S one-seed
    ``GeneratorDraws`` both give seed s's rows as its one-seed draws: the
    raw rows from its own generator, scaled by its own rows of ``[B, 1]``
    bounds (never seed 0's)."""
    B, nu = S * 3, 4
    low = -torch.arange(1.0, B + 1.0)[:, None]          # [B, 1]: every row its own range
    high = torch.arange(1.0, B + 1.0)[:, None] * 2.0
    make = lambda: [torch.Generator().manual_seed(x) for x in (7, 13)]
    joint, seeded = GeneratorDraws(make(), "cpu"), SeedDraws([GeneratorDraws(g, "cpu") for g in make()])
    singles = [GeneratorDraws(g, "cpu") for g in make()]
    rows = lambda s: slice(3 * s, 3 * s + 3)
    calls = [
        lambda d, s=None: d.uniform((B, nu) if s is None else (3, nu), low if s is None else low[rows(s)],
                                     high if s is None else high[rows(s)]),
        lambda d, s=None: d.randint((B,) if s is None else (3,), 1, 5),
        lambda d, s=None: d.bernoulli(0.3, (B, 2) if s is None else (3, 2)),
        lambda d, s=None: d.uniform((B,) if s is None else (3,)),
    ]
    for call in calls:
        want = torch.cat([call(singles[s], s) for s in range(S)])
        assert torch.equal(call(joint), want) and torch.equal(call(seeded), want)
    assert not torch.equal(want[:3], want[3:])


def test_two_seed_env_matches_jax_vmapped(float64):
    from rlx_tpu.environments.locomotion.robot.tpu.default_config import get_config as jax_get_config
    from rlx_tpu.environments.locomotion.robot.tpu.environment import LocomotionEnv as JaxLocomotionEnv

    jconfig, config = configs(jax_get_config, get_config, "locomotion.robot",
                              {"nr_envs": N, "robot": "quadruped", "terrain.type": "plane"})
    jenv = JaxLocomotionEnv(jconfig, N)
    env = LocomotionEnv(config, S * N, device="cpu")
    jreset = jax.jit(jax.vmap(lambda key: record_draws(jenv.reset)(key, False)))
    jstep = jax.jit(jax.vmap(record_draws(jenv.step)))

    jstate, draws = jreset(jnp.stack([jax.random.PRNGKey(3), jax.random.PRNGKey(8)]))
    state = env.reset([0, 1], draws=_seed_draws(draws))
    folded = _fold(jstate)
    close_tree(state.physics, dict(folded.physics), TOL, "reset physics")
    close_tree(state.info, dict(folded.info), TOL, "reset info")
    np.testing.assert_allclose(state.observation.numpy(), np.asarray(folded.observation), rtol=TOL, atol=TOL)
    # the seeds' draws differ, so a seed given the other's rows would fail
    assert not np.allclose(np.asarray(jstate.observation)[0], np.asarray(jstate.observation)[1], atol=1e-3)

    # the reset lifts the float32 pose until a foot touches the ground
    # exactly, and whether the first step's contact brings its damper turns
    # on the last bit of that pose, which the two engines round apart: the
    # steps start from JAX's pose (as ``torch_robot_parity.run_steps``)
    jstate = to64(jstate)
    carried = port_state(_fold(jstate))
    for name in ("qpos", "contact_anchor"):
        state.physics[name] = carried.physics[name]
    rng = np.random.default_rng(5)
    for i in range(2):
        action = rng.uniform(-1.0, 1.0, size=(S, N, env.nr_actuator_joints))
        jstate, draws = jstep(jstate, jnp.asarray(action))
        jstate = to64(jstate)
        with torch.no_grad():
            state = env.step(state, torch.tensor(action.reshape(S * N, -1)), draws=_seed_draws(draws))
        close_env_state(env, state, _fold(jstate), TOL, f"step {i}")
    assert state.observation.shape == (S * N, 61)


def _ppo_lstm(seed, nr_seeds):
    """PPO-LSTM on the plane robot: one iteration of 2 envs x 8 steps and an
    evaluation, with episodes cut to 16 control steps; a timestep of 10 ms
    (2 substeps a control step) halves the plain engine's time on the CPU."""
    config = make_config("ppo_lstm.cuda", "locomotion.robot.cuda", **{
        "runner.device": "cpu", "environment.seed": seed, "environment.terrain.type": "plane",
        "environment.nr_envs": 2, "environment.timestep": 0.01,
        "algorithm.nr_steps": 8, "algorithm.total_timesteps": 16, "algorithm.evaluation_and_save_frequency": 16,
        "algorithm.nr_minibatches": 2, "algorithm.nr_epochs": 2, "algorithm.obs_encoding_dim": 16,
        "algorithm.rnn_hidden_dim": 16, "algorithm.critic_hidden_sizes": (16, 16),
        "algorithm.logging_active": False, "algorithm.nr_parallel_seeds": nr_seeds})
    train_env, eval_env = create_env(config)
    for env in {train_env, eval_env}:
        env.horizon = 16
    return create_model(config, train_env, eval_env)


def test_seed_one_of_two_is_its_one_seed_run_on_the_robot(float64):
    """In float64 and over a short episode: the seed-batched and the
    one-seed policy round apart in the last bits, and an evaluation at the
    full randomization of eval mode grows that ~10x a control step through
    the contacts (~1e-3 in the tracking after 50 steps in f32, and in
    float64 too)."""
    from rlx_tpu_torch.algorithms.training_program import run_training_program

    seed = 11
    two = _ppo_lstm(seed, 2)
    assert two.train_env.nr_envs == 4
    indices = {name: m.observation_indices for name, m in (("policy", two.policy), ("critic", two.critic))}
    _, eval_history = run_training_program(two)
    stacked = {f"{name}.{k}": v.detach().clone() for name, m in (("policy", two.policy), ("critic", two.critic))
               for k, v in m.named_parameters()}
    # the asymmetric index sets stay one buffer, not stacked per seed
    assert indices["policy"].ndim == 1 and two.policy.observation_indices is indices["policy"]
    assert indices["critic"].ndim == 1 and two.critic.observation_indices is indices["critic"]
    assert len(indices["policy"]) == 45 and len(indices["critic"]) == 61

    one = _ppo_lstm(seed_for(seed, 1), 1)
    one.train()
    for name, m in (("policy", one.policy), ("critic", one.critic)):
        for k, v in m.named_parameters():
            assert stacked[f"{name}.{k}"].shape == (2,) + tuple(v.shape)
            torch.testing.assert_close(stacked[f"{name}.{k}"][1], v, rtol=1e-5, atol=1e-5,
                                       msg=lambda msg: f"{name}.{k}: {msg}")
    assert "eval/episode_tracking" in eval_history
    for key, value in one.eval_history.items():
        if key != "steps":
            assert eval_history[key].shape == (2, 1), key
            np.testing.assert_allclose(eval_history[key][1], value, rtol=1e-4, atol=1e-4, err_msg=key)
    # seed 0 ran from its own draws
    assert not np.allclose(eval_history["eval/episode_tracking"][0], eval_history["eval/episode_tracking"][1])
