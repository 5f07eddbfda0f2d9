"""The port's rendering (``rlx_tpu_torch/render``) against the JAX package's
(``tests/test_render.py``): the numpy ray tracer draws JAX's image of the
same pose (within 1 per channel), the PNG and mp4 sinks, ``rollout_qpos``
(the device half) against JAX's rollout of the same converted parameters
on the Ant (float32: JAX's Ant does not run under x64, its engine's scan
carries float32; 1e-5), ``render_rollout``'s frames, the interactive
viewer's key and camera state machine on a stub backend, test mode's
``runner.render_video``, and the render keys on every registration."""

import os

import numpy as np
import pytest

from rlx_tpu_torch import convert
from rlx_tpu_torch.config import create_model, make_config
from rlx_tpu_torch.environments.locomotion.ant.cuda.environment import ANT_XML
from rlx_tpu_torch.render import OffscreenRenderer, VideoWriter, render_rollout
from rlx_tpu_torch.render.offscreen import rollout_qpos
from rlx_tpu_torch.runner.runner import Runner
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)


@pytest.fixture(autouse=True)
def software_rendering(monkeypatch):
    """Both ray tracers, whatever ran before in this process: the dm_control
    and native host bridges set ``MUJOCO_GL=egl`` when a host-env test
    imports them, and with it set both renderers probe GL, which aborts a
    process that has none (a worker then goes down mid-test)."""
    monkeypatch.delenv("MUJOCO_GL", raising=False)


PPO = {"environment.nr_envs": 2, "algorithm.nr_steps": 8, "algorithm.minibatch_size": 8, "algorithm.nr_epochs": 1,
       "algorithm.total_timesteps": 32, "algorithm.policy_hidden_sizes": (16, 16),
       "algorithm.critic_hidden_sizes": (16, 16)}


def test_software_render_matches_jax():
    """The same pose drawn by both ray tracers (no GL here): sky, checker
    floor and body pixels, the same within 1 per channel; moving the body
    changes the image."""
    import mujoco

    from rlx_tpu.render import OffscreenRenderer as JaxRenderer

    qpos = np.asarray(mujoco.MjModel.from_xml_path(ANT_XML).key_qpos[0], np.float64)
    qpos[7:] += np.linspace(-0.3, 0.3, qpos.shape[0] - 7)
    ours, ref = OffscreenRenderer(ANT_XML, width=96, height=72), JaxRenderer(ANT_XML, width=96, height=72)
    image, expected = ours.render(qpos), ref.render(qpos)
    assert image.shape == (72, 96, 3) and image.dtype == np.uint8
    assert np.abs(image.astype(int) - expected.astype(int)).max() <= 1
    assert len(np.unique(image.reshape(-1, 3), axis=0)) > 50
    moved = qpos.copy()
    moved[0] += 0.5
    assert (ours.render(moved) != image).any()
    ours.close()
    ref.close()


def test_video_writer_png_and_mp4(tmp_path):
    frames = [np.full((32, 48, 3), v, np.uint8) for v in (0, 128, 255)]
    writer = VideoWriter(str(tmp_path / "frames"))
    for frame in frames:
        writer.add(frame)
    writer.close()
    assert sorted(os.listdir(tmp_path / "frames")) == ["frame_00000.png", "frame_00001.png", "frame_00002.png"]
    try:
        import cv2  # noqa: F401
    except ImportError:
        return   # the mp4 sink needs OpenCV
    writer = VideoWriter(str(tmp_path / "clip.mp4"), fps=10)
    for frame in frames:
        writer.add(frame)
    writer.close()
    assert (tmp_path / "clip.mp4").stat().st_size > 0


def test_rollout_qpos_matches_jax():
    """Env 0's pose before each of 3 deterministic steps from an eval reset,
    with JAX's PPO parameters converted: the port's device half against
    JAX's ``render_rollout`` loop (its reset with key 0, ``policy.mode``
    through ``process_action``), float32 on both sides."""
    import jax

    from rlx_tpu.config import create_model as jax_create_model
    from rlx_tpu.config import make_config as jax_make_config
    from rlx_tpu.render.offscreen import deterministic_act_fn

    jmodel = jax_create_model(jax_make_config("ppo.tpu", "locomotion.ant.tpu", **PPO, **{"runner.mesh_dp": 1}))
    params = jax.tree.map(np.asarray, jmodel.policy_state.params)
    # a policy that moves the Ant: the zero-init head scaled up
    params["params"]["Dense_0"]["kernel"] = params["params"]["Dense_0"]["kernel"] * 300.0
    jmodel.policy_state = jmodel.policy_state.replace(params=params)
    act, env = deterministic_act_fn(jmodel), jmodel.eval_env
    state, step = env.reset(jax.random.PRNGKey(0), eval_mode=True), jax.jit(env.step)
    expected = []
    for _ in range(3):
        expected.append(np.asarray(state.physics.qpos[0]))
        state = step(state, act(state.observation))

    model = create_model(make_config("ppo.cuda", "locomotion.ant.cuda", **PPO, **{"runner.device": "cpu"}))
    model.policy.module.load_state_dict(convert.policy_state_dict(params))
    poses = rollout_qpos(model, 3)
    assert poses.shape == (3, 15) and poses.dtype == np.float32
    assert np.abs(np.diff(poses[:, 7:], axis=0)).max() > 1e-3   # the joints move
    np.testing.assert_allclose(poses, np.asarray(expected), rtol=1e-5, atol=1e-5)


def test_render_rollout_writes_frames(tmp_path):
    model = create_model(make_config("ppo.cuda", "locomotion.ant.cuda", **PPO, **{"runner.device": "cpu"}))
    assert render_rollout(model, str(tmp_path / "rollout"), nr_steps=3, width=48, height=36) == 3
    assert len(os.listdir(tmp_path / "rollout")) == 3
    pendulum = create_model(make_config("ppo.cuda", "classic.pendulum.cuda", **{"runner.device": "cpu"}))
    with pytest.raises(ValueError, match="xml_path"):
        rollout_qpos(pendulum, 3)


class _FakeBackend:
    """Stub render backend driving ``InteractiveViewer``'s state machine."""

    def __init__(self):
        self.frames, self.camera_history, self.zooms = [], [], []
        self.closed, self._should_close = False, False

    def set_camera(self, mode):
        self.camera_history.append(mode)

    def set_key_callback(self, cb):
        self.key_cb = cb

    def set_scroll_callback(self, cb):
        self.scroll_cb = cb

    def zoom(self, amount):
        self.zooms.append(amount)

    def track(self, data):
        pass

    def render_frame(self, data, overlay_lines):
        self.frames.append(overlay_lines)

    def should_close(self):
        return self._should_close

    def close(self):
        self.closed = True


def test_interactive_viewer_state_machine():
    """SPACE pause, TAB camera cycle, H menu, S / F speed, scroll zoom, the
    overlay, window close (the JAX package's test, on the port's viewer)."""
    from rlx_tpu_torch.render.interactive import InteractiveViewer

    backend = _FakeBackend()
    viewer = InteractiveViewer(model=None, dt=1 / 60.0, backend=backend)
    viewer.target_render_time = 0.0
    assert viewer.camera_mode == "static"
    backend.key_cb("tab")
    viewer.render(data=None)
    assert viewer.camera_mode == "follow" and backend.camera_history[-1] == "follow"
    backend.key_cb("s")
    backend.key_cb("s")
    assert viewer.run_speed_factor == 0.25
    backend.key_cb("f")
    assert viewer.run_speed_factor == 0.5
    backend.key_cb("h")
    viewer.render(data=None)
    assert backend.frames[-1] is None
    backend.key_cb("h")
    viewer.render(data=None)
    lines = dict(backend.frames[-1])
    assert lines["Camera mode:"] == "follow" and "[S]lower, [F]aster" in lines.values()
    backend.scroll_cb(2.0)
    assert backend.zooms == [0.1]
    backend.key_cb("space")
    spins = {"n": 0}
    render_frame = backend.render_frame

    def unpause_after_three(data, overlay):
        render_frame(data, overlay)
        spins["n"] += 1
        if spins["n"] == 3:
            backend.key_cb("space")

    backend.render_frame = unpause_after_three
    viewer.render(data=None)
    assert not viewer.paused and spins["n"] >= 3
    backend._should_close = True
    viewer.render(data=None)
    viewer.close()
    assert backend.closed


def test_runner_test_mode_writes_a_clip(tmp_path, monkeypatch):
    """Train and save a tiny Ant PPO, then test mode from its checkpoint with
    ``--runner.render_video=<dir>``: the test episodes, then the frames."""
    monkeypatch.chdir(tmp_path)
    common = ["--algorithm.name=ppo.cuda", "--environment.name=locomotion.ant.cuda", "--runner.device=cpu",
              "--environment.nr_envs=2", "--environment.horizon=4", "--runner.mesh_dp=1"]
    Runner(common + ["--runner.save_model=True", "--algorithm.nr_steps=4", "--algorithm.minibatch_size=8",
                     "--algorithm.nr_epochs=1", "--algorithm.total_timesteps=8",
                     "--algorithm.policy_hidden_sizes=(16, 16)", "--algorithm.critic_hidden_sizes=(16, 16)"]).run()
    model_path = tmp_path / "runs" / "rlx_tpu_torch" / "default" / "run" / "models" / "latest.model"
    returns = Runner(common + ["--runner.mode=test", f"--runner.load_model={model_path}",
                               "--runner.nr_test_episodes=1", f"--runner.render_video={tmp_path / 'clip'}",
                               "--runner.render_interactive=False"]).run()
    assert len(returns) == 1
    assert sorted(os.listdir(tmp_path / "clip")) == [f"frame_{i:05d}.png" for i in range(4)]


def test_render_keys_on_every_registration():
    """``environment.render`` (False) on every env registration, as in the
    JAX package, and the runner's two test-mode keys with JAX's defaults."""
    from test_torch_mesh import _registrations

    for name in _registrations():
        config = make_config("ppo.cuda", name, **{"environment.render": "false"})
        assert config.environment.render is False, name
    runner = make_config("ppo.cuda", "classic.pendulum.cuda").runner
    assert (runner.render_video, runner.render_interactive) == ("", False)
