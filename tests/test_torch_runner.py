"""The port's Runner in its three modes, on Pendulum on the CPU: train with
``save_model`` into a run directory, test mode from the saved
``latest.model``, show_config, profiling, and the runner keys left out of
the port."""

import logging
import os

import numpy as np
import pytest
import torch

from rlx_tpu_torch.runner.runner import Runner
from rlx_tpu_torch.utils.logging import rlx_logger

PENDULUM = ["--environment.name=classic.pendulum.cuda", "--runner.device=cpu", "--environment.nr_envs=4"]
ALGORITHMS = {
    "ppo.cuda": ["--algorithm.nr_steps=8", "--algorithm.minibatch_size=16", "--algorithm.nr_epochs=2",
                 "--algorithm.total_timesteps=64", "--algorithm.evaluation_and_save_frequency=32",
                 "--algorithm.policy_hidden_sizes=(16, 16)", "--algorithm.critic_hidden_sizes=(16, 16)"],
    "fasttd3.cuda": ["--algorithm.total_timesteps=64", "--algorithm.learning_starts=32",
                     "--algorithm.batch_size=16", "--algorithm.buffer_size=256", "--algorithm.nr_atoms=11",
                     "--algorithm.logging_frequency=16", "--algorithm.evaluation_and_save_frequency=16",
                     "--algorithm.policy_hidden_sizes=(16, 16)", "--algorithm.critic_hidden_sizes=(16, 16)"],
}
MODEL = os.path.join("runs", "rlx_tpu_torch", "default", "run", "models", "latest.model")


@pytest.mark.parametrize("algorithm", sorted(ALGORITHMS))
def test_train_save_then_test_mode(tmp_path, monkeypatch, algorithm):
    monkeypatch.chdir(tmp_path)
    args = [f"--algorithm.name={algorithm}", *PENDULUM, *ALGORITHMS[algorithm]]
    trained = Runner([*args, "--runner.save_model=True"]).run()
    run_dir = tmp_path / "runs" / "rlx_tpu_torch" / "default" / "run"
    assert (run_dir / "provenance.json").exists()
    assert sorted(os.listdir(run_dir / "models")) == ["best.model", "latest.model"]
    assert len(trained.eval_history["steps"]) == 2

    runner = Runner([f"--algorithm.name={algorithm}", *PENDULUM, "--runner.mode=test",
                     f"--runner.load_model={MODEL}", "--runner.nr_test_episodes=6"])
    returns = runner.run()
    assert len(returns) == 6 and all(np.isfinite(returns))
    # the stored algorithm config came back with the model
    assert runner.model.config.algorithm.policy_hidden_sizes == (16, 16)
    for a, b in zip(trained.policy.module.parameters(), runner.model.policy.module.parameters()):
        assert torch.equal(a, b)


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


@pytest.mark.parametrize("key", ["track_tb", "track_wandb", "wandb_entity", "notes", "render_video",
                                 "render_interactive"])
def test_left_out_runner_keys_raise(key):
    with pytest.raises(KeyError):
        Runner([f"--runner.{key}=True"])


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="Unknown runner mode"):
        Runner(["--runner.mode=bogus", "--runner.device=cpu"]).run()
