"""Interactive GLFW viewer of the port (opt-in; requires a GL stack).

Behavior parity with the reference's per-env MuJoCo viewer
(`rl_x/environments/custom_mujoco/ant/mjx/viewer.py:7-189`):

- SPACE pauses/resumes (render loop keeps spinning while paused),
- TAB cycles camera modes static (free, elevated) <-> follow (tracking),
- H hides the help/overlay menu,
- S / F halve / double the real-time speed factor,
- mouse drag rotates/moves the camera, scroll zooms,
- a shadow-font overlay shows the controls, camera mode, speed, framerate,
- frame pacing targets 60 Hz and converts sim time to wall time through
  ``loop_count += dt / (time_per_render * run_speed_factor)``.

The module imports neither ``glfw`` nor ``mujoco`` until the real backend
(``_GlfwBackend``) is made, and the render/window plumbing is injectable:
tests drive the state machine (pause, camera cycle, speed, pacing, overlay
text) through a stub backend (``tests/test_torch_render.py``), and the
real path runs where ``glfw`` and a display are present.  The runner's test
mode opens it with ``--runner.render_interactive=True``.
"""

import time
from itertools import cycle

import numpy as np


class InteractiveViewer:
    """Drives a GLFW window around host-side mjModel/mjData.

    ``backend=None`` imports the real glfw+mujoco render stack; tests pass a
    stub implementing the same surface (see ``tests/test_torch_render.py``).
    """

    CAMERA_MODES = ("static", "follow")

    def __init__(self, model, dt, backend=None):
        self.model = model
        self.dt = dt
        self.backend = backend if backend is not None else _GlfwBackend(model)

        self.paused = False
        self.hide_menu = False
        self.run_speed_factor = 1.0
        self.target_render_time = 1 / 60.0
        self.time_per_render = self.target_render_time
        self.loop_count = 0.0
        self.frames = 0
        self._closed = False

        self._camera_iter = cycle(self.CAMERA_MODES)
        self.camera_mode = next(self._camera_iter)
        self.camera_mode_target = self.camera_mode
        self.backend.set_camera(self.camera_mode)
        self._last_render_time = time.time()

        self.backend.set_key_callback(self._on_key)
        self.backend.set_scroll_callback(self._on_scroll)

    # ---------------------------------------------------------------- input
    def _on_key(self, key, released=True):
        if not released:
            return
        if key == "space":
            self.paused = not self.paused
        elif key == "h":
            self.hide_menu = not self.hide_menu
        elif key == "tab":
            self.camera_mode_target = next(self._camera_iter)
        elif key == "s":
            self.run_speed_factor /= 2.0
        elif key == "f":
            self.run_speed_factor *= 2.0

    def _on_scroll(self, y_offset):
        self.backend.zoom(0.05 * y_offset)

    # -------------------------------------------------------------- overlay
    def overlay_lines(self):
        lines = [
            ("Press SPACE to pause.", ""),
            ("Press H to hide the menu.", ""),
            ("Press TAB to switch cameras.", ""),
            ("Camera mode:", self.camera_mode),
            ("Run speed = %.3f x real time" % self.run_speed_factor, "[S]lower, [F]aster"),
            ("Framerate:", str(int(1 / max(self.time_per_render, 1e-6) * self.run_speed_factor))),
        ]
        return lines

    # ----------------------------------------------------------------- loop
    def _render_once(self, data):
        overlay = None if self.hide_menu else self.overlay_lines()
        self.backend.render_frame(data, overlay)
        self.frames += 1
        if self.backend.should_close():
            self._closed = True
            return
        elapsed = time.time() - self._last_render_time
        if self.target_render_time > elapsed:
            time.sleep(self.target_render_time - elapsed)
        now = time.time()
        self.time_per_render = now - self._last_render_time
        self._last_render_time = now

    def render(self, data):
        """Called once per env step with host-side state; blocks while paused
        and paces sim time against wall time."""
        while self.paused and not self._closed:
            self._render_once(data)
        self.loop_count += self.dt / (self.time_per_render * self.run_speed_factor)
        while self.loop_count > 0 and not self._closed:
            self._render_once(data)
            if self.camera_mode_target != self.camera_mode:
                self.backend.set_camera(self.camera_mode_target)
                self.camera_mode = self.camera_mode_target
            self.backend.track(data)
            self.loop_count -= 1

    @property
    def closed(self):
        return self._closed

    def close(self):
        self._closed = True
        self.backend.close()


class _GlfwBackend:
    """Real GLFW + MuJoCo render stack (only constructed when available)."""

    def __init__(self, model):
        import glfw
        import mujoco

        self._glfw = glfw
        self._mujoco = mujoco
        self.model = model
        if not glfw.init():
            raise RuntimeError("glfw.init() failed (no display / GL stack?)")
        glfw.window_hint(glfw.SCALE_TO_MONITOR, glfw.TRUE)
        mode = glfw.get_video_mode(glfw.get_primary_monitor())
        self.window = glfw.create_window(mode.size.width, mode.size.height,
                                         "rlx_tpu_torch", None, None)
        glfw.make_context_current(self.window)
        self.scene = mujoco.MjvScene(model, 1000)
        self.scene_option = mujoco.MjvOption()
        self.camera = mujoco.MjvCamera()
        mujoco.mjv_defaultFreeCamera(model, self.camera)
        self.context = mujoco.MjrContext(model, mujoco.mjtFontScale(100))
        w, h = glfw.get_framebuffer_size(self.window)
        self.viewport = mujoco.MjrRect(0, 0, w, h)
        self._key_cb = None
        self._last_cursor = (0.0, 0.0)

        glfw.set_key_callback(self.window, self._glfw_key)
        glfw.set_scroll_callback(self.window, self._glfw_scroll)
        glfw.set_cursor_pos_callback(self.window, self._glfw_cursor)

    # callbacks -------------------------------------------------------------
    def set_key_callback(self, cb):
        self._key_cb = cb

    def set_scroll_callback(self, cb):
        self._scroll_cb = cb

    def _glfw_key(self, window, key, scancode, act, mods):
        if self._key_cb is None or act != self._glfw.RELEASE:
            return
        names = {self._glfw.KEY_SPACE: "space", self._glfw.KEY_H: "h",
                 self._glfw.KEY_TAB: "tab", self._glfw.KEY_S: "s",
                 self._glfw.KEY_F: "f"}
        if key in names:
            self._key_cb(names[key])

    def _glfw_scroll(self, window, x_offset, y_offset):
        self._scroll_cb(y_offset)

    def _glfw_cursor(self, window, x, y):
        glfw, mujoco = self._glfw, self._mujoco
        dx, dy = x - self._last_cursor[0], y - self._last_cursor[1]
        self._last_cursor = (x, y)
        left = glfw.get_mouse_button(self.window, glfw.MOUSE_BUTTON_LEFT) == glfw.PRESS
        right = glfw.get_mouse_button(self.window, glfw.MOUSE_BUTTON_RIGHT) == glfw.PRESS
        if not (left or right):
            return
        shift = glfw.get_key(self.window, glfw.KEY_LEFT_SHIFT) == glfw.PRESS
        if right:
            action = mujoco.mjtMouse.mjMOUSE_MOVE_H if shift else mujoco.mjtMouse.mjMOUSE_MOVE_V
        else:
            action = mujoco.mjtMouse.mjMOUSE_ROTATE_H if shift else mujoco.mjtMouse.mjMOUSE_ROTATE_V
        w, h = glfw.get_framebuffer_size(self.window)
        mujoco.mjv_moveCamera(self.model, action, dx / w, dy / h, self.scene, self.camera)

    # camera ----------------------------------------------------------------
    def set_camera(self, mode):
        mujoco = self._mujoco
        if mode == "static":
            self.camera.type = mujoco.mjtCamera.mjCAMERA_FREE
            self.camera.trackbodyid = -1
            self.camera.distance = 15.0
            self.camera.elevation = -45.0
            self.camera.azimuth = 90.0
        else:  # follow
            self.camera.type = mujoco.mjtCamera.mjCAMERA_TRACKING
            self.camera.trackbodyid = 0
            self.camera.distance = 3.5
            self.camera.elevation = 0.0
            self.camera.azimuth = 90.0

    def zoom(self, amount):
        mujoco = self._mujoco
        mujoco.mjv_moveCamera(self.model, mujoco.mjtMouse.mjMOUSE_ZOOM, 0, amount,
                              self.scene, self.camera)

    def track(self, data):
        pass  # tracking camera follows trackbodyid natively

    # frame -----------------------------------------------------------------
    def render_frame(self, data, overlay_lines):
        glfw, mujoco = self._glfw, self._mujoco
        mujoco.mjv_updateScene(self.model, data, self.scene_option, None,
                               self.camera, mujoco.mjtCatBit.mjCAT_ALL, self.scene)
        self.viewport.width, self.viewport.height = glfw.get_framebuffer_size(self.window)
        mujoco.mjr_render(self.viewport, self.scene, self.context)
        if overlay_lines:
            left = "\n".join(t for t, _ in overlay_lines)
            right = "\n".join(v for _, v in overlay_lines)
            mujoco.mjr_overlay(mujoco.mjtFont.mjFONT_SHADOW,
                               mujoco.mjtGridPos.mjGRID_TOPLEFT,
                               self.viewport, left, right, self.context)
        glfw.swap_buffers(self.window)
        glfw.poll_events()

    def should_close(self):
        return bool(self._glfw.window_should_close(self.window))

    def close(self):
        self._glfw.destroy_window(self.window)


def watch_rollout(model, xml_path, max_steps=None, backend=None, seed=0):
    """Interactive test-mode rollout: the deterministic policy on env 0 of
    ``model.eval_env`` (stepped on the model's device), shown in a viewer
    window.  ``xml_path`` is the env's MJCF for the host-side render model.
    Returns the number of env steps shown."""
    import mujoco
    import torch

    from rlx_tpu_torch.render.offscreen import _qpos, deterministic_act_fn

    env = model.eval_env
    render_model = mujoco.MjModel.from_xml_path(xml_path)
    render_data = mujoco.MjData(render_model)
    # one env.step spans the env's control period (frame skip x physics
    # timestep); pacing by opt.timestep alone would play nr_substeps too fast
    dt = float(getattr(env, "dt", render_model.opt.timestep))
    viewer = InteractiveViewer(render_model, dt, backend=backend)

    act = deterministic_act_fn(model)
    steps = 0
    horizon = max_steps or env.horizon
    try:
        with torch.no_grad():
            state = env.reset(seed, eval_mode=True)
            while steps < horizon and not viewer.closed:
                state = env.step(state, act(state.observation))
                render_data.qpos[:] = _qpos(state.physics)[0].cpu().numpy().astype(np.float64)
                mujoco.mj_forward(render_model, render_data)
                viewer.render(render_data)
                steps += 1
    finally:
        viewer.close()
    return steps
