"""The port's dp mesh (``rlx_tpu_torch/parallel/mesh.py``) on the CPU, in
2 gloo ranks (``torch_mesh_worker.py``), spawned once a session
(``torch_mesh_spawn.shared_results``; each parametrized case reads its
result):

- with shard-local options off, dp = 2 equals dp = 1 for every algorithm
  family at a tiny size after one iteration (on-policy) or a prefill and 8
  learning steps (off-policy), an evaluation included: every parameter,
  running statistic, normalizer and the eval history, in float64 within
  1e-9 (the Ant and the host Pendulum in float32, within 1e-5);
- with shard-local on, at dp = 2 each rank's result matches the JAX
  package at ``mesh_dp=2`` on its virtual CPU devices fed the same
  indices: PPO's ``_optimize`` with JAX's per-shard epoch permutations,
  SAC's sample (batch row i from env shard i % dp) and update with JAX's
  ``t_idx`` / ``e_idx`` and normals (f32: 1e-5);
- checkpoints through the runner at dp = 2: rank 0 writes, a load
  broadcasts, per-env states saved whole and restored into rows;
- the keys: ``runner.mesh_dp`` / ``mesh_tp`` / ``coordinator_address``,
  ``environment.render`` and each family's ``shard_local_*`` parse on
  every registration, and at one process the mesh is the identity.

The ranks import no JAX (the worker checks); the JAX side runs here.
"""

import threading

import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from rlx_tpu_torch import convert
from rlx_tpu_torch.algorithms.flashsac.cuda.flashsac import FlashSAC
from rlx_tpu_torch.config import create_model, make_config
from rlx_tpu_torch.parallel import mesh as mesh_lib
from torch_mesh_spawn import shared_results, spawn
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

WORLD = 2
CASES = list(worker.FAMILIES)
PPO = {"environment.nr_envs": 4, "algorithm.nr_steps": 4, "algorithm.minibatch_size": 8, "algorithm.nr_epochs": 2,
       "algorithm.total_timesteps": 32, "algorithm.policy_hidden_sizes": (16, 16),
       "algorithm.critic_hidden_sizes": (16, 16), "algorithm.activation": "elu", "algorithm.layer_norm": True,
       "algorithm.entropy_coef": 0.01, "algorithm.logging_active": False, "algorithm.evaluation_active": False}
SAC = {"environment.nr_envs": 4, "algorithm.batch_size": 8, "algorithm.policy_hidden_sizes": (16, 16),
       "algorithm.critic_hidden_sizes": (16, 16), "algorithm.total_timesteps": 320, "algorithm.learning_starts": 64,
       "algorithm.logging_active": False}


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _ppo_inputs(directory):
    """The JAX PPO at mesh_dp=2 (shard-local), its converted parameters, an
    env-major batch and its per-shard permutations into ``ppo_inputs.pt``;
    returns the function that runs JAX's ``_optimize``."""
    import jax

    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config

    jmodel = jax_create_model(jax_make_config("ppo.tpu", "locomotion.ant.tpu", **PPO, **{"runner.mesh_dp": WORLD}))
    assert jmodel.shard_local_minibatching
    n = 16
    rng = np.random.default_rng(0)
    batch = (rng.normal(size=(n, 34)).astype(np.float32), rng.normal(size=(n, 8)).astype(np.float32),
             rng.normal(size=n).astype(np.float32) - 8.0, rng.normal(size=n).astype(np.float32),
             rng.normal(size=n).astype(np.float32))
    key = jax.random.PRNGKey(7)
    _, perm_key = jax.random.split(key)
    epoch_indices = jax.random.permutation(perm_key, np.tile(np.arange(n // WORLD), (2, WORLD, 1)), axis=-1,
                                           independent=True)
    torch.save({"overrides": PPO, "policy": convert.policy_state_dict(_np_tree(jmodel.policy_state.params)),
                "critic": convert.critic_state_dict(_np_tree(jmodel.critic_state.params)),
                "batch": tuple(torch.tensor(x) for x in batch),
                "epoch_indices": torch.tensor(np.asarray(epoch_indices))}, directory / "ppo_inputs.pt")

    def run():
        policy_state, critic_state, metrics = jmodel._optimize(jmodel.policy_state, jmodel.critic_state, batch, key)
        torch.save({"policy": convert.policy_state_dict(_np_tree(policy_state.params)),
                    "critic": convert.critic_state_dict(_np_tree(critic_state.params)),
                    "metrics": {k: torch.tensor(float(v)) for k, v in metrics.items()}},
                   directory / "ppo_shard_local.jax.pt")
    return run


def _sac_inputs(directory):
    """The JAX SAC at mesh_dp=2 with a filled replay: its sample with
    shard-local sampling and one update, and what the ranks need to repeat
    them (``sac_inputs.pt``); returns the function that runs JAX's."""
    import jax

    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config
    from rlx_tpu.ops import replay_buffer as jax_rb

    jmodel = jax_create_model(jax_make_config("sac.tpu", "classic.pendulum.tpu", **SAC, **{"runner.mesh_dp": WORLD}))
    nr_envs, rows, b = 4, 6, 8
    rng = np.random.default_rng(1)
    replay = {"observation": rng.normal(size=(rows, nr_envs, 3)), "next_observation": rng.normal(size=(rows, nr_envs, 3)),
              "action": rng.uniform(-1, 1, size=(rows, nr_envs, 1)), "reward": rng.normal(size=(rows, nr_envs)),
              "terminated": (rng.random((rows, nr_envs)) < 0.25).astype(np.float64),
              "truncated": np.zeros((rows, nr_envs))}
    replay = {k: v.astype(np.float32) for k, v in replay.items()}
    buffer = jax_rb.create(16, nr_envs, {k: (v.shape[2:], np.float32) for k, v in replay.items()})
    for t in range(rows):
        buffer = jax_rb.add(buffer, {k: v[t] for k, v in replay.items()})
    sample_key, update_key = jax.random.PRNGKey(3), jax.random.PRNGKey(4)
    time_key, env_key = jax.random.split(sample_key)
    t_idx = jax.random.randint(time_key, (b,), 0, rows)
    e_idx = (np.arange(b) % WORLD) * (nr_envs // WORLD) + np.asarray(
        jax.random.randint(env_key, (b,), 0, nr_envs // WORLD))
    target_key, current_key = jax.random.split(update_key)
    draws = {name: torch.tensor(np.asarray(jax.random.normal(k, (b, 1))))
             for name, k in (("target_noise", target_key), ("current_noise", current_key))}
    states = jmodel.states
    torch.save({"overrides": SAC, "replay": {k: torch.tensor(v) for k, v in replay.items()},
                "t_idx": torch.tensor(np.asarray(t_idx)).long(), "e_idx": torch.tensor(e_idx).long(),
                "draws": draws,
                "policy": convert.squashed_gaussian_policy_state_dict(_np_tree(states["policy"].params)),
                "critic": convert.vector_q_critic_state_dict(_np_tree(states["critic"].params)),
                "critic_target": convert.vector_q_critic_state_dict(_np_tree(states["critic"].target_params)),
                "alpha": convert.entropy_coefficient_state_dict(_np_tree(states["alpha"].params))},
               directory / "sac_inputs.pt")

    def run():
        batch = jax_rb.sample(buffer, sample_key, b, shard_local=True, dp_size=WORLD)
        new_states, metrics = jax.jit(jmodel.update)(states, batch, update_key, 0)
        torch.save({"batch": {k: torch.tensor(np.asarray(v)) for k, v in batch.items()},
                    "policy": convert.squashed_gaussian_policy_state_dict(_np_tree(new_states["policy"].params)),
                    "critic": convert.vector_q_critic_state_dict(_np_tree(new_states["critic"].params)),
                    "critic_target": convert.vector_q_critic_state_dict(_np_tree(new_states["critic"].target_params)),
                    "alpha": convert.entropy_coefficient_state_dict(_np_tree(new_states["alpha"].params)),
                    "metrics": {k: torch.tensor(float(v)) for k, v in metrics.items()}},
                   directory / "sac_shard_local.jax.pt")
    return run


@pytest.fixture(scope="session")
def mesh_results(tmp_path_factory):
    """One spawn of 2 ranks a session: every family at dp = 2 and its dp = 1
    reference, and the shard-local PPO and SAC; JAX's side meanwhile here."""
    def run(directory):
        jax_runs = [_ppo_inputs(directory), _sac_inputs(directory)]
        failure = []

        def ranks():
            try:
                spawn(["families", "ppo_shard_local", "sac_shard_local", "checkpoints"], WORLD, directory, CASES)
            except BaseException as e:   # handed to the test below
                failure.append(e)

        thread = threading.Thread(target=ranks)
        thread.start()
        for jax_run in jax_runs:
            jax_run()
        thread.join()
        if failure:
            raise failure[0]

    return shared_results(tmp_path_factory, "torch_mesh", run)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def _assert_trees_close(ours, ref, tol, what):
    ours, ref = dict(_leaves(ours)), dict(_leaves(ref))
    assert set(ours) == set(ref), (what, sorted(set(ours) ^ set(ref)))
    for key, value in ref.items():
        got = ours[key]
        if value.is_floating_point():
            torch.testing.assert_close(got.double(), value.double(), rtol=tol, atol=tol,
                                       msg=lambda m: f"{what} {key}: {m}")
        else:
            assert torch.equal(got, value), (what, key)


@pytest.mark.parametrize("case", CASES)
def test_dp2_equals_dp1(mesh_results, case):
    """Shard-local off: the dp = 2 run's parameters, statistics and eval
    history are the dp = 1 run's up to the order of the reductions."""
    ours = torch.load(mesh_results / f"{case}.dp.pt")
    ref = torch.load(mesh_results / f"{case}.ref.pt")
    assert ref["eval_history"], case   # an evaluation ran, its means over both ranks' envs
    _assert_trees_close(ours, ref, 1e-5 if case in worker.FLOAT32 else 1e-9, case)


def test_ppo_shard_local_matches_jax(mesh_results):
    """Each rank permutes its own env-major rows (JAX's per-shard epoch
    indices), minibatches of minibatch_size / dp rows, advantages normalized
    over the global minibatch, gradients averaged before the clip."""
    ours = torch.load(mesh_results / "ppo_shard_local.dp.pt")
    ref = torch.load(mesh_results / "ppo_shard_local.jax.pt")
    _assert_trees_close({k: ours[k] for k in ("policy", "critic")}, {k: ref[k] for k in ("policy", "critic")},
                        1e-5, "ppo")
    assert set(ours["metrics"]) == set(ref["metrics"])
    for key, value in ref["metrics"].items():
        np.testing.assert_allclose(float(ours["metrics"][key]), float(value), rtol=1e-4, atol=1e-5, err_msg=key)


def test_sac_shard_local_matches_jax(mesh_results):
    """Rank r's batch is JAX's rows i % 2 == r (env shard i % dp, global
    time index), and one update on them equals JAX's update of the whole."""
    ref = torch.load(mesh_results / "sac_shard_local.jax.pt")
    for rank in range(WORLD):
        batch = torch.load(mesh_results / f"sac_shard_local.batch{rank}.pt")["batch"]
        for key, value in ref["batch"].items():
            torch.testing.assert_close(batch[key].reshape(value[rank::WORLD].shape), value[rank::WORLD],
                                       msg=lambda m: f"rank {rank} {key}: {m}")
    ours = torch.load(mesh_results / "sac_shard_local.dp.pt")
    states = ("policy", "critic", "critic_target", "alpha")
    _assert_trees_close({k: ours[k] for k in states}, {k: ref[k] for k in states}, 1e-5, "sac")
    for key, value in ref["metrics"].items():
        np.testing.assert_allclose(float(ours["metrics"][key]), float(value), rtol=1e-4, atol=1e-5, err_msg=key)


def test_checkpoints_at_dp2(mesh_results):
    """Through the runner at dp = 2: only rank 0 writes the run directory
    (one ``provenance.json``, ``latest.model`` and ``best.model``), every
    rank loads the same state (rank 0 reads the file and broadcasts it),
    optimizer state included, bit for bit; FlashSAC's checkpoint holds
    every env's held noise and running return (both ranks' rows) and a
    load through ``load`` gives each rank its own rows."""
    ranks = [torch.load(mesh_results / f"checkpoints.rank{r}.pt") for r in range(WORLD)]
    assert ranks[0]["files"] == ["diff.patch", "models", "provenance.json"]
    assert sorted(p.name for p in (mesh_results / "runs/rlx_tpu_torch/default/ppo/models").iterdir()) == [
        "best.model", "latest.model"]
    for rank in ranks:
        _assert_trees_close(rank["trained"], ranks[0]["trained"], 0.0, "trained")
        _assert_trees_close(rank["loaded"], ranks[0]["trained"], 0.0, "loaded")
    saved = ranks[0]["flashsac"]["saved"]
    assert set(saved) == {"noise", "reward_normalizer"}
    for name, keys in FlashSAC.env_row_states.items():
        for key in keys:
            whole = saved[name][key]
            assert whole.shape[0] == 4, (name, key)
            torch.testing.assert_close(whole, torch.cat([r["flashsac"]["rank_rows"][name][key] for r in ranks]),
                                       rtol=0, atol=0)
            for r, rank in enumerate(ranks):
                # the load gives each rank its own rows of the saved whole, not rank 0's
                torch.testing.assert_close(rank["flashsac"]["loaded_rows"][name][key], whole[2 * r:2 * r + 2],
                                           rtol=0, atol=0)


def _registrations():
    """Every env registration of the port: the ``<...>/cuda`` and
    ``<...>/host`` packages under ``rlx_tpu_torch/environments``, each
    imported (so registered), by name."""
    import importlib
    import os

    from rlx_tpu_torch.environments.environment_manager import registered_environment_names

    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "rlx_tpu_torch", "environments")
    names = []
    for directory, _, files in os.walk(root):
        if "__init__.py" in files and os.path.basename(directory) in ("cuda", "host"):
            names.append(os.path.relpath(directory, root).replace(os.sep, "."))
            importlib.import_module("rlx_tpu_torch.environments." + names[-1])
    assert set(names) <= set(registered_environment_names())
    return sorted(names)


def test_mesh_and_render_keys_parse_on_every_registration():
    """JAX command lines carry these keys: each parses, with JAX's
    defaults, on every env registration (28) and every family's
    ``shard_local_*`` key on its own config."""
    from rlx_tpu_torch.algorithms.algorithm_manager import registered_algorithm_names

    names = _registrations()
    assert len(names) == 28
    for name in names:
        config = make_config("ppo.cuda", name, **{
            "environment.render": "False", "runner.mesh_dp": "1", "runner.mesh_tp": "1",
            "runner.coordinator_address": "localhost:1234", "runner.render_video": "clip.mp4",
            "runner.render_interactive": "False"})
        assert config.environment.render is False and config.runner.mesh_dp == 1, name
    defaults = make_config("ppo.cuda", "classic.pendulum.cuda").runner
    assert (defaults.mesh_dp, defaults.mesh_tp, defaults.coordinator_address) == (-1, 1, "")
    for algorithm in registered_algorithm_names():
        config = make_config(algorithm, "classic.pendulum.cuda")
        key = "shard_local_minibatching" if "shard_local_minibatching" in config.algorithm else "shard_local_sampling"
        if key in config.algorithm:
            assert config.algorithm[key] is True
            assert make_config(algorithm, "classic.pendulum.cuda", **{f"algorithm.{key}": "False"}
                               ).algorithm[key] is False


def test_one_process_mesh_is_the_identity():
    """No process group: ``mesh_dp = -1`` is one rank, every helper an
    identity, and a model's mesh is the one-device mesh."""
    mesh = mesh_lib.make_mesh(-1, 1)
    assert (mesh.dp, mesh.tp, mesh.dp_group) == (1, 1, None)
    x = torch.arange(6.0).reshape(3, 2)
    assert mesh.rows(x) is x and mesh.gather_rows(x) is x and mesh.all_reduce_sum(x) is x
    mean, var = mesh.global_mean_var(x)
    assert float(mean) == 2.5 and float(var) == pytest.approx(float(x.var(unbiased=False)))
    assert mesh_lib.initialize_distributed("") == 1
    model = create_model(make_config("ppo.cuda", "classic.pendulum.cuda", **{
        "runner.device": "cpu", "runner.mesh_dp": "1", "environment.nr_envs": 4}))
    assert model.mesh.dp == 1 and model.train_env.nr_envs == 4
    with pytest.raises(ValueError, match="needs 4 processes"):
        mesh_lib.make_mesh(2, 2)
