"""The runner's ``track_tb`` (TensorBoard scalars through a lazily imported
``tensorboardX``, as the JAX runner writes them) and ``matmul_precision``
(the counterpart of the JAX package's ``jax_default_matmul_precision``,
mapped onto ``torch.set_float32_matmul_precision``; float32 by default)."""

import glob
import os

import pytest
import torch

from rlx_tpu_torch.config import MATMUL_PRECISIONS, create_env, make_config
from rlx_tpu_torch.runner.runner import Runner
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

PPO = ["--runner.device=cpu", "--environment.nr_envs=2", "--algorithm.nr_steps=8", "--algorithm.minibatch_size=8",
       "--algorithm.nr_epochs=1", "--algorithm.total_timesteps=32", "--algorithm.evaluation_active=False"]


def _scalars(path):
    """{tag: [(step, value)]} of a TensorBoard event file (TFRecord: a
    length, its CRC, the serialized ``Event``, its CRC)."""
    import struct

    from tensorboardX.proto import event_pb2

    with open(path, "rb") as f:
        data = f.read()
    out, i = {}, 0
    while i < len(data):
        (length,) = struct.unpack("<Q", data[i:i + 8])
        event = event_pb2.Event()
        event.ParseFromString(data[i + 12:i + 12 + length])
        i += 12 + length + 4
        for value in event.summary.value:
            out.setdefault(value.tag, []).append((event.step, value.simple_value))
    return out


def test_track_tb_writes_the_logged_scalars(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    model = Runner([*PPO, "--runner.track_tb=True", "--runner.run_name=tb"]).run()
    (events,) = glob.glob(os.path.join(tmp_path, "runs", "rlx_tpu_torch", "default", "tb", "tb", "events.*"))
    scalars = _scalars(events)
    assert "time/sps" in scalars
    steps, values = zip(*scalars["loss/critic_loss"])
    assert steps == (16, 32) and len(model.metrics_history) == 2
    assert values == pytest.approx([m["loss/critic_loss"] for m in model.metrics_history], rel=1e-6)


def test_no_writer_without_track_tb(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    Runner([*PPO, "--runner.run_name=no_tb"]).run()
    assert not os.path.exists(os.path.join(tmp_path, "runs", "rlx_tpu_torch", "default", "no_tb", "tb"))


@pytest.mark.parametrize("name, torch_name", [("float32", "highest"), ("tensorfloat32", "high"),
                                              ("bfloat16", "medium")])
def test_matmul_precision(name, torch_name):
    before = torch.get_float32_matmul_precision()
    try:
        create_env(make_config("ppo.cuda", "classic.pendulum.cuda", **{
            "runner.device": "cpu", "runner.matmul_precision": name}))
        assert torch.get_float32_matmul_precision() == torch_name == MATMUL_PRECISIONS[name]
    finally:
        torch.set_float32_matmul_precision(before)


def test_matmul_precision_defaults_to_float32_and_refuses_other_names():
    assert make_config("ppo.cuda", "classic.pendulum.cuda").runner.matmul_precision == "float32"
    with pytest.raises(ValueError, match="matmul_precision"):
        create_env(make_config("ppo.cuda", "classic.pendulum.cuda", **{
            "runner.device": "cpu", "runner.matmul_precision": "float16"}))
