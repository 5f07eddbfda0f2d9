"""The port's Runner in its three modes, on Pendulum on the CPU: train with
``save_model`` into a run directory, test mode from the saved
``latest.model``, show_config, profiling, and the runner keys left out of
the port.  Then the flags typed as ``ml_collections`` types them, the
defaults (the JAX runner's algorithm and environment; ``cuda`` as the
device on purpose), and a second ``train()`` from a fresh reset."""

import logging
import os

import numpy as np
import pytest
import torch

from rlx_tpu_torch.config import create_model, make_config
from rlx_tpu_torch.runner.runner import Runner, parse_flags
from rlx_tpu_torch.utils.logging import rlx_logger
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

PENDULUM = ["--environment.name=classic.pendulum.cuda", "--runner.device=cpu", "--environment.nr_envs=4"]
ALGORITHMS = {
    "ppo.cuda": ["--algorithm.nr_steps=8", "--algorithm.minibatch_size=16", "--algorithm.nr_epochs=2",
                 "--algorithm.total_timesteps=64", "--algorithm.evaluation_and_save_frequency=32",
                 "--algorithm.policy_hidden_sizes=(16, 16)", "--algorithm.critic_hidden_sizes=(16, 16)"],
    "fasttd3.cuda": ["--algorithm.total_timesteps=64", "--algorithm.learning_starts=32",
                     "--algorithm.batch_size=16", "--algorithm.buffer_size=256", "--algorithm.nr_atoms=11",
                     "--algorithm.logging_frequency=16", "--algorithm.evaluation_and_save_frequency=16",
                     "--algorithm.policy_hidden_sizes=(16, 16)", "--algorithm.critic_hidden_sizes=(16, 16)"],
    **{name: ["--algorithm.total_timesteps=64", "--algorithm.learning_starts=32", "--algorithm.batch_size=16",
              "--algorithm.buffer_size=256", "--algorithm.logging_frequency=16",
              "--algorithm.evaluation_and_save_frequency=16", "--algorithm.policy_hidden_sizes=(16, 16)",
              "--algorithm.critic_hidden_sizes=(16, 16)"]
       for name in ("sac.cuda", "td3.cuda", "ddpg.cuda")},
}
MODEL = os.path.join("runs", "rlx_tpu_torch", "default", "run", "models", "latest.model")
CARTPOLE = ["--environment.name=classic.cart_pole.cuda", "--runner.device=cpu", "--environment.nr_envs=4",
            "--environment.horizon=20"]
DISCRETE = ["--algorithm.total_timesteps=64", "--algorithm.learning_starts=32", "--algorithm.batch_size=16",
            "--algorithm.buffer_size=256", "--algorithm.logging_frequency=16",
            "--algorithm.evaluation_and_save_frequency=16", "--algorithm.critic_hidden_sizes=(16,)"]
# case -> (algorithm, environment flags, algorithm flags)
CASES = {
    **{name: (name, PENDULUM, args) for name, args in ALGORITHMS.items()},
    **{f"{name}-cart_pole": (name, CARTPOLE, DISCRETE) for name in ("dqn.cuda", "c51.cuda")},
    "pqn.cuda-cart_pole": ("pqn.cuda", CARTPOLE, [
        "--algorithm.total_timesteps=64", "--algorithm.nr_steps=8", "--algorithm.evaluation_and_save_frequency=32",
        "--algorithm.critic_hidden_sizes=(16,)"]),
    **{f"{name}-masked_pendulum": (name, [*PENDULUM, "--environment.mask_velocity=True"], ALGORITHMS["ppo.cuda"])
       for name in ("ppo.cuda", "ppo_history_window.cuda", "ppo_memory_actions.cuda")},
    "ppo.cuda-cart_pole": ("ppo.cuda", CARTPOLE, ALGORITHMS["ppo.cuda"]),
}


def _equal_trees(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _equal_trees(a[k], b[k])
        else:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_save_then_test_mode(tmp_path, monkeypatch, case):
    algorithm, environment, algorithm_args = CASES[case]
    monkeypatch.chdir(tmp_path)
    args = [f"--algorithm.name={algorithm}", *environment, *algorithm_args]
    trained = Runner([*args, "--runner.save_model=True"]).run()
    run_dir = tmp_path / "runs" / "rlx_tpu_torch" / "default" / "run"
    assert (run_dir / "provenance.json").exists()
    # PQN keeps latest.model only, as the JAX package's
    models = ["latest.model"] if algorithm == "pqn.cuda" else ["best.model", "latest.model"]
    assert sorted(os.listdir(run_dir / "models")) == models
    assert len(trained.eval_history["steps"]) == 2

    runner = Runner([f"--algorithm.name={algorithm}", *environment, "--runner.mode=test",
                     f"--runner.load_model={MODEL}", "--runner.nr_test_episodes=6"])
    returns = runner.run()
    assert len(returns) == 6 and all(np.isfinite(returns))
    # the stored algorithm config came back with the model
    hidden = runner.model.config.algorithm.critic_hidden_sizes
    assert hidden == trained.config.algorithm.critic_hidden_sizes in ((16, 16), (16,))
    _equal_trees(trained.checkpoint_tree(), runner.model.checkpoint_tree())


def test_explicit_algorithm_flags_win_over_the_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ["--algorithm.name=ppo.cuda", *PENDULUM, *ALGORITHMS["ppo.cuda"]]
    Runner([*args, "--runner.save_model=True", "--algorithm.evaluation_active=False"]).run()
    runner = Runner(["--algorithm.name=ppo.cuda", *PENDULUM, "--runner.mode=test",
                     f"--runner.load_model={MODEL}", "--runner.nr_test_episodes=1",
                     "--algorithm.learning_rate=0.5"])
    runner.run()
    algorithm = runner.model.config.algorithm
    assert algorithm.learning_rate == 0.5          # set here
    assert algorithm.nr_epochs == 2                 # stored (the default is 10)
    assert algorithm.evaluation_active is False     # stored


def test_chunked_train_runs_the_same_loop(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ["--algorithm.name=ppo.cuda", *PENDULUM, *ALGORITHMS["ppo.cuda"]]
    histories = [Runner([*args, f"--runner.chunked_train={chunked}"]).run().eval_history
                 for chunked in (False, True)]
    assert set(histories[0]) == set(histories[1])
    for k in histories[0]:
        np.testing.assert_array_equal(histories[0][k], histories[1][k])


def test_profile_dir_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    Runner(["--algorithm.name=ppo.cuda", *PENDULUM, *ALGORITHMS["ppo.cuda"],
            "--algorithm.evaluation_active=False", f"--runner.profile_dir={tmp_path / 'profile'}"]).run()
    assert (tmp_path / "profile" / "trace.json").stat().st_size > 0


def test_show_config_prints_the_three_namespaces():
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    rlx_logger.addHandler(handler)
    try:
        config = Runner(["--runner.mode=show_config", "--algorithm.nr_steps=7"]).run()
    finally:
        rlx_logger.removeHandler(handler)
    text = "\n".join(r.getMessage() for r in records)
    for namespace in ("runner", "algorithm", "environment"):
        assert f'"{namespace}"' in text
    assert '"nr_steps": 7' in text and config.algorithm.nr_steps == 7


# track_tb, the render keys and the mesh keys are ported (tests/test_torch_render.py,
# tests/test_torch_mesh.py); jax_default_matmul_precision's counterpart is matmul_precision
@pytest.mark.parametrize("key", ["jax_default_matmul_precision", "track_wandb", "wandb_entity", "notes",
                                 "jax_compilation_cache_dir", "pallas_kernels"])
def test_left_out_runner_keys_raise(key):
    with pytest.raises(KeyError):
        Runner([f"--runner.{key}=True"])


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="Unknown runner mode"):
        Runner(["--runner.mode=bogus", "--runner.device=cpu"]).run()


# --- typed flags, defaults, repeated train() -----------------------------------

TYPED = ["--runner.run_name=1", "--runner.save_model=True", "--algorithm.evaluation_active=false",
         "--algorithm.target_entropy=-3.0", "--algorithm.learning_rate=1", "--algorithm.batch_size=0x40",
         "--algorithm.policy_hidden_sizes=(64, 64)", "--algorithm.critic_hidden_sizes=[32]"]


def test_flags_are_typed_as_ml_collections_types_them():
    """The same command line through ``ml_collections.config_flags`` on the
    JAX package's configs and through the port: equal values of equal type
    (``run_name=1`` stays the text ``"1"``, ``false`` is ``False``,
    ``learning_rate=1`` the float 1.0, a tuple stays a tuple)."""
    from absl import flags
    from ml_collections import config_flags

    from rlx_tpu.algorithms.sac.tpu.default_config import get_config as jax_sac_config
    from rlx_tpu.runner.default_config import get_config as jax_runner_config

    argv = ["prog", *TYPED]
    flag_values = flags.FlagValues()
    holders = {name: config_flags.DEFINE_config_dict(name, config, flag_values=flag_values, sys_argv=argv)
               for name, config in (("runner", jax_runner_config()), ("algorithm", jax_sac_config("sac.tpu")))}
    flag_values(argv)
    config = make_config("sac.cuda", "classic.pendulum.cuda", **parse_flags(TYPED))
    for arg in TYPED:
        namespace, field = arg[2:].split("=", 1)[0].split(".")
        expected, got = holders[namespace].value[field], config[namespace][field]
        assert got == expected and type(got) is type(expected), (arg, got, expected)
    assert config.runner.run_name == "1" and config.algorithm.evaluation_active is False


@pytest.mark.parametrize("arg", ["--algorithm.evaluation_active=yes", "--algorithm.nr_epochs=2.5",
                                 "--algorithm.learning_rate=fast"])
def test_a_value_that_does_not_fit_its_field_raises(arg):
    with pytest.raises(ValueError):
        Runner(["--runner.mode=show_config", arg])


def test_runner_run_name_given_as_a_number_makes_its_run_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    Runner(["--algorithm.name=ddpg.cuda", *PENDULUM, *ALGORITHMS["ddpg.cuda"], "--runner.run_name=1",
            "--algorithm.evaluation_active=false"]).run()
    assert (tmp_path / "runs" / "rlx_tpu_torch" / "default" / "1" / "provenance.json").exists()


def test_defaults_follow_the_jax_runner_except_the_device(tmp_path, monkeypatch):
    """Algorithm and environment as the JAX runner's; the device is
    ``cuda`` on purpose (the JAX package's ``""`` is its default backend):
    without a card a bare run fails, it does not train on the CPU."""
    import rlx_tpu.runner.runner as jax_runner

    runner = Runner(["--runner.mode=show_config"])
    assert runner.algorithm_name == jax_runner.DEFAULT_ALGORITHM.replace(".tpu", ".cuda") == "ppo.cuda"
    assert runner.environment_name == jax_runner.DEFAULT_ENVIRONMENT.replace(".tpu", ".cuda")
    assert runner.environment_name == "classic.pendulum.cuda"
    assert runner.config.runner.device == "cuda"
    if torch.cuda.is_available():
        return
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Runner([]).run()


SECOND_TRAIN = {
    "ppo.cuda": {"algorithm.nr_steps": 8, "algorithm.minibatch_size": 16, "algorithm.nr_epochs": 2,
                 "algorithm.total_timesteps": 64},
    "fasttd3.cuda": {"algorithm.total_timesteps": 64, "algorithm.learning_starts": 32,
                     "algorithm.batch_size": 16, "algorithm.buffer_size": 256, "algorithm.nr_atoms": 11,
                     "algorithm.logging_frequency": 16},
}


@pytest.mark.parametrize("algorithm", sorted(SECOND_TRAIN))
def test_a_second_train_starts_from_a_fresh_reset(algorithm):
    """The first ``train()`` resets from the environment's seed, as before;
    the second from another seed, drawn from the model's host generator,
    as the JAX package splits a fresh key.  PPO logs each call's own update
    count, as JAX does."""
    config = make_config(algorithm, "classic.pendulum.cuda", **{
        "runner.device": "cpu", "environment.nr_envs": 4, "algorithm.evaluation_active": False,
        "algorithm.policy_hidden_sizes": (16, 16), "algorithm.critic_hidden_sizes": (16, 16),
        **SECOND_TRAIN[algorithm]})
    model, fresh = create_model(config), create_model(config)
    resets = []
    reset = model.train_env.reset
    model.train_env.reset = lambda seed, **kw: resets.append((seed, reset(seed, **kw))) or resets[-1][1]
    model.train()
    first = [dict(m) for m in model.metrics_history]
    model.train()
    fresh.train()
    (seed_1, state_1), (seed_2, state_2) = resets
    assert seed_1 == config.environment.seed and seed_2 != seed_1
    assert not torch.equal(state_1.observation, state_2.observation)
    # the first call is the one a fresh model makes
    drop = lambda m: {k: v for k, v in m.items() if k != "time/sps"}
    assert [drop(m) for m in first] == [drop(m) for m in fresh.metrics_history]
    updates = [m["steps/nr_updates"] for m in model.metrics_history]
    assert updates[len(first):] == updates[:len(first)]
    if algorithm == "ppo.cuda":
        assert updates == [4, 8, 4, 8] and model.nr_optimizer_steps == 16
