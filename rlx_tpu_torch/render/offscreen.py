"""Headless offscreen rollout renderer of the port.

The runner's test mode calls it with ``--runner.render_video=<path>``
(``runner/runner.py``), as the JAX package's runner calls its own
(``rlx_tpu/render/offscreen.py``).  The rollout is split in two:

- ``rollout_qpos(model, nr_steps)``, the device half: a seeded eval-mode
  reset of ``model.eval_env`` on the model's device and deterministic steps
  through the env (on the card the Ant steps through kernel B2), returning
  env 0's ``qpos`` before each step as a ``[T, nq]`` numpy array;
- ``render_qpos`` / ``render_rollout``, the host half: each pose rendered
  by ``OffscreenRenderer`` and written by ``VideoWriter``.

``OffscreenRenderer`` is the JAX package's: MuJoCo's GL renderer only when
``MUJOCO_GL`` is ``egl`` or ``osmesa`` (probing GL where there is none can
abort the process), else a numpy ray tracer that uses MuJoCo C only for
geometry (``mj_forward`` -> the world pose of every geom) and traces
spheres, capsules (as sphere-swept segments), boxes (oriented slab test)
and a checkerboard ground plane, with Lambert and distance-fog shading.
``mujoco`` is imported only by the renderer, so the device half runs
where MuJoCo is missing.

Output: ``.mp4`` through OpenCV's ``VideoWriter``, or a PNG sequence when
the target is a directory.
"""

import os

import numpy as np
import torch


class OffscreenRenderer:
    def __init__(self, xml_path, width=480, height=360, camera_distance=None):
        import mujoco

        self.m = mujoco.MjModel.from_xml_path(xml_path)
        self.d = mujoco.MjData(self.m)
        self.width = width
        self.height = height
        self._mujoco = mujoco
        self._gl_renderer = None
        # hardware path only on explicit opt-in: probing GL in a GL-less
        # image can hard-abort the process (GLFW), not just raise
        if os.environ.get("MUJOCO_GL") in ("egl", "osmesa"):
            try:
                self._gl_renderer = mujoco.Renderer(self.m, height, width)
            except Exception:
                self._gl_renderer = None

        # characteristic scale for the default orbit camera
        ext = float(self.m.stat.extent) if self.m.stat.extent > 0 else 1.0
        self.camera_distance = camera_distance or 2.2 * ext
        self.azimuth_deg = 135.0
        self.elevation_deg = -20.0

    # ------------------------------------------------------------ geometry
    def _forward(self, qpos):
        self.d.qpos[:] = np.asarray(qpos, np.float64)
        self.d.qvel[:] = 0.0
        self._mujoco.mj_forward(self.m, self.d)

    def _lookat(self):
        """Track the root body (first body after world) if present."""
        if self.m.nbody > 1:
            return self.d.xpos[1].copy()
        return np.zeros(3)

    # ---------------------------------------------------------- rendering
    def render(self, qpos):
        """qpos [nq] -> RGB uint8 [H, W, 3]."""
        self._forward(qpos)
        if self._gl_renderer is not None:
            self._gl_renderer.update_scene(self.d)
            return self._gl_renderer.render()
        return self._render_software()

    def _camera_rays(self, target):
        az = np.deg2rad(self.azimuth_deg)
        el = np.deg2rad(self.elevation_deg)
        forward = np.array([
            np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)
        ])
        eye = target - self.camera_distance * forward
        up_world = np.array([0.0, 0.0, 1.0])
        right = np.cross(forward, up_world)
        right /= np.linalg.norm(right)
        up = np.cross(right, forward)

        fov = np.deg2rad(45.0)
        aspect = self.width / self.height
        ys = np.linspace(np.tan(fov / 2), -np.tan(fov / 2), self.height)
        xs = np.linspace(-np.tan(fov / 2) * aspect, np.tan(fov / 2) * aspect, self.width)
        xg, yg = np.meshgrid(xs, ys)
        dirs = (forward[None, None] + xg[..., None] * right[None, None]
                + yg[..., None] * up[None, None])
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        return eye, dirs.reshape(-1, 3)

    def _render_software(self):
        mujoco = self._mujoco
        eye, dirs = self._camera_rays(self._lookat())
        n_rays = dirs.shape[0]
        t_best = np.full(n_rays, np.inf)
        normal = np.zeros((n_rays, 3))
        color = np.zeros((n_rays, 3))

        def commit(t, mask, n, c):
            better = mask & (t < t_best)
            t_best[better] = t[better]
            normal[better] = n[better]
            color[better] = c if c.ndim == 1 else c[better]

        # collect primitive lists from the mujoco geom table
        spheres = []   # (center, radius, rgba)
        boxes = []     # (center, R, half_sizes, rgba)
        plane_z = None
        for g in range(self.m.ngeom):
            gtype = self.m.geom_type[g]
            pos = self.d.geom_xpos[g]
            R = self.d.geom_xmat[g].reshape(3, 3)
            size = self.m.geom_size[g]
            rgba = self.m.geom_rgba[g][:3]
            if not self.m.geom_rgba[g].any():
                rgba = np.array([0.6, 0.62, 0.65])
            if gtype == mujoco.mjtGeom.mjGEOM_PLANE:
                plane_z = pos[2]
            elif gtype == mujoco.mjtGeom.mjGEOM_SPHERE:
                spheres.append((pos, size[0], rgba))
            elif gtype == mujoco.mjtGeom.mjGEOM_CAPSULE:
                # sphere-swept segment approximated by K spheres
                half = size[1]
                axis = R[:, 2]
                for s in np.linspace(-half, half, max(int(2 * half / max(size[0], 1e-3)) + 2, 2)):
                    spheres.append((pos + s * axis, size[0], rgba))
            elif gtype == mujoco.mjtGeom.mjGEOM_BOX:
                boxes.append((pos, R, size.copy(), rgba))

        # spheres (vectorized over rays x spheres in chunks)
        if spheres:
            centers = np.array([s[0] for s in spheres])
            radii = np.array([s[1] for s in spheres])
            cols = np.array([s[2] for s in spheres])
            oc = eye[None, :] - centers            # [S, 3]
            b = dirs @ oc.T                         # [R, S]
            c = (oc * oc).sum(-1)[None, :] - radii[None, :] ** 2
            disc = b * b - c
            hit = disc > 0
            sqrt_disc = np.sqrt(np.maximum(disc, 0))
            t = -b - sqrt_disc
            t = np.where(hit & (t > 1e-4), t, np.inf)
            s_idx = np.argmin(t, axis=1)
            t_min = t[np.arange(n_rays), s_idx]
            mask = np.isfinite(t_min)
            pts = eye[None] + dirs * t_min[:, None]
            n = pts - centers[s_idx]
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
            commit(t_min, mask, n, cols[s_idx])

        # boxes: oriented slab test
        for pos, R, half, rgba in boxes:
            ro = (eye - pos) @ R                    # ray origin in box frame
            rd = dirs @ R
            safe_rd = np.where(np.abs(rd) < 1e-9, 1e-9, rd)
            t1 = (-half[None] - ro[None]) / safe_rd
            t2 = (half[None] - ro[None]) / safe_rd
            tmin = np.minimum(t1, t2).max(axis=-1)
            tmax = np.maximum(t1, t2).min(axis=-1)
            mask = (tmax > np.maximum(tmin, 1e-4)) & (tmin > 1e-4)
            pts_local = ro[None] + tmin[:, None] * rd
            face = np.argmax(np.abs(pts_local) / half[None], axis=-1)
            n_local = np.zeros((n_rays, 3))
            n_local[np.arange(n_rays), face] = np.sign(
                pts_local[np.arange(n_rays), face]
            )
            commit(tmin, mask, n_local @ R.T, np.asarray(rgba))

        # ground plane with checkerboard
        if plane_z is not None:
            denom = dirs[:, 2]
            t = (plane_z - eye[2]) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
            mask = (t > 1e-4) & (denom < 0)
            pts = eye[None] + dirs * t[:, None]
            checker = ((np.floor(pts[:, 0]) + np.floor(pts[:, 1])) % 2).astype(bool)
            plane_col = np.where(checker[:, None], [0.38, 0.45, 0.38], [0.46, 0.53, 0.46])
            commit(t, mask, np.broadcast_to([0.0, 0.0, 1.0], (n_rays, 3)).copy(), plane_col)

        # shading: Lambert + ambient + distance fog; sky background
        light = np.array([0.35, 0.3, 0.89])
        light /= np.linalg.norm(light)
        lambert = np.clip(normal @ light, 0.0, 1.0)
        shade = (0.35 + 0.65 * lambert)[:, None] * color
        fog = np.clip(t_best / (6.0 * self.camera_distance), 0.0, 1.0)[:, None]
        sky = np.array([0.70, 0.78, 0.90])
        img = np.where(
            np.isfinite(t_best)[:, None], shade * (1 - fog) + sky[None] * fog, sky[None]
        )
        return (np.clip(img, 0, 1).reshape(self.height, self.width, 3) * 255).astype(np.uint8)

    def close(self):
        if self._gl_renderer is not None:
            self._gl_renderer.close()


class VideoWriter:
    """MP4 (OpenCV) or PNG-sequence sink, chosen by the target path."""

    def __init__(self, path, fps=50):
        self.path = path
        self.fps = fps
        self._writer = None
        self._frame_idx = 0
        self._is_mp4 = path.endswith(".mp4")
        if not self._is_mp4:
            os.makedirs(path, exist_ok=True)

    def add(self, frame):
        if self._is_mp4:
            import cv2

            if self._writer is None:
                os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
                h, w = frame.shape[:2]
                self._writer = cv2.VideoWriter(
                    self.path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w, h)
                )
            self._writer.write(frame[..., ::-1])  # RGB -> BGR
        else:
            from PIL import Image

            Image.fromarray(frame).save(
                os.path.join(self.path, f"frame_{self._frame_idx:05d}.png")
            )
        self._frame_idx += 1

    def close(self):
        if self._writer is not None:
            self._writer.release()


def deterministic_act_fn(model):
    """The deterministic action of a trained model, ready for its env: the
    on-policy families' ``policy.mode`` through ``policy.process_action``,
    the off-policy families' ``eval_act`` through ``process_action``.
    Shared by the offscreen and the interactive viewers."""
    policy = getattr(model, "policy", None)
    if policy is not None and hasattr(policy, "mode") and hasattr(policy, "process_action"):
        return lambda obs: policy.process_action(policy.mode(obs))
    if hasattr(model, "eval_act"):
        return lambda obs: model.process_action(model.eval_act(obs))
    raise ValueError(f"don't know how to act deterministically with {type(model).__name__}")


def _qpos(physics):
    return physics["qpos"] if isinstance(physics, dict) else physics.qpos


def _require_xml_path(env):
    xml_path = getattr(env, "xml_path", None)
    if xml_path is None:
        raise ValueError(
            f"environment {type(env).__name__} exposes no xml_path; "
            "offscreen rendering supports the engine-backed device envs"
        )
    return xml_path


def default_nr_steps(env):
    """The default clip length: the env's horizon, at most 250 steps
    (software rendering costs ~0.2 s a frame)."""
    return min(env.horizon, 250)


@torch.no_grad()
def rollout_qpos(model, nr_steps=None, seed=0):
    """The device half of ``render_rollout``: env 0's ``qpos`` before each of
    ``nr_steps`` deterministic steps of ``model.eval_env`` from an eval-mode
    reset with ``seed``, as a ``[nr_steps, nq]`` numpy array."""
    env = model.eval_env
    _require_xml_path(env)
    act = deterministic_act_fn(model)
    nr_steps = nr_steps or default_nr_steps(env)
    state = env.reset(seed, eval_mode=True)
    poses = []
    for _ in range(nr_steps):
        poses.append(_qpos(state.physics)[0])
        state = env.step(state, act(state.observation))
    return torch.stack(poses).cpu().numpy()


def render_qpos(xml_path, poses, path, width=480, height=360, fps=50):
    """The host half: one frame of each pose of ``poses`` (``[T, nq]``) into
    ``path``; returns the frame count."""
    renderer = OffscreenRenderer(xml_path, width, height)
    writer = VideoWriter(path, fps)
    try:
        for qpos in poses:
            writer.add(renderer.render(qpos))
    finally:
        writer.close()
        renderer.close()
    return len(poses)


def render_rollout(model, path, nr_steps=None, width=480, height=360, fps=None):
    """Roll the trained policy on the eval env (``rollout_qpos``) and write
    env 0's frames to ``path`` (``render_qpos``); envs without ``xml_path``
    raise ``ValueError``.  Returns the frame count."""
    env = model.eval_env
    xml_path = _require_xml_path(env)
    poses = rollout_qpos(model, nr_steps)
    return render_qpos(xml_path, poses, path, width, height, fps or int(round(1.0 / getattr(env, "dt", 0.02))))
