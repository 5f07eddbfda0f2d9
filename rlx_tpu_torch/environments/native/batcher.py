"""ctypes bindings and the env protocol for the native C++ env batchers.

Three C++ batchers (the framework's EnvPool equivalent) step their envs on
a thread pool with same-step auto-reset and episode statistics:
``envbatch.cpp`` (pendulum, cart_pole; no dependency), ``envbatch_mujoco.cpp``
(Gymnasium's MuJoCo v5 hopper, half_cheetah, walker2d) and
``envbatch_dmc.cpp`` (dm_control's cheetah_run, walker_walk, walker_run),
the latter two against the installed ``mujoco`` wheel's C library.  Each is
compiled by ``g++`` at first use into ``build/rlx_tpu_torch``
(``ops/_build.py::load_host``).  The C++ writes a step's results straight
into the host edge's staging buffer (``gym/host_bridge.py``), which one
copy carries to ``runner.device``.
"""

import ctypes
import hashlib
import os

import numpy as np

from rlx_tpu_torch.environments.gym.host_bridge import HostEnv
from rlx_tpu_torch.environments.spaces import BoxSpace, DiscreteSpace
from rlx_tpu_torch.ops import _build

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))

ENV_SPECS = {
    "pendulum": dict(discrete=False, act_dim=1, act_low=-2.0, act_high=2.0),
    "cart_pole": dict(discrete=True, nr_actions=2),
}

_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _mujoco_flags():
    """(compile, link) flags against the installed mujoco wheel's C library
    (include/ and libmujoco.so.<version> ship inside the package)."""
    import mujoco

    pkg_dir = os.path.dirname(os.path.abspath(mujoco.__file__))
    libname = next(f for f in sorted(os.listdir(pkg_dir)) if f.startswith("libmujoco.so"))
    return ([f"-I{os.path.join(pkg_dir, 'include')}"],
            [f"-L{pkg_dir}", f"-l:{libname}", f"-Wl,-rpath,{pkg_dir}"])


def _library(prefix):
    """The bound library of one batcher: ``envbatch``, ``mjbatch`` or ``dmcbatch``."""
    source = {"envbatch": "envbatch.cpp", "mjbatch": "envbatch_mujoco.cpp",
              "dmcbatch": "envbatch_dmc.cpp"}[prefix]
    compile_flags, link_flags = ([], []) if prefix == "envbatch" else _mujoco_flags()
    lib = _build.load_host(os.path.join(NATIVE_DIR, source), compile_flags, [*link_flags, "-lpthread"])
    fn = lambda name: getattr(lib, f"{prefix}_{name}")
    fn("create").restype = ctypes.c_void_p
    if prefix == "envbatch":
        fn("create").argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_int]
        dims = ["obs_dim", "horizon"]
    else:
        fn("create").argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_int]
        dims = ["obs_dim", "act_dim", "horizon"]
        fn("ctrl_range").argtypes = [ctypes.c_void_p, _F32P, _F32P]
        fn("set_state").argtypes = [ctypes.c_void_p, ctypes.c_int, _F64P, _F64P]
        fn("get_state").argtypes = [ctypes.c_void_p, ctypes.c_int, _F64P, _F64P]
    for name in dims:
        fn(name).restype = ctypes.c_int
        fn(name).argtypes = [ctypes.c_void_p]
    fn("reset").argtypes = [ctypes.c_void_p, _F32P]
    fn("step").argtypes = [ctypes.c_void_p, _F32P, _F32P, _F32P, _F32P, _U8P, _U8P, _F32P]
    fn("destroy").argtypes = [ctypes.c_void_p]
    return fn


class NativeEnvBatch(HostEnv):
    """C++-vectorized classic-control envs (``pendulum``, ``cart_pole``)."""

    PREFIX = "envbatch"

    def __init__(self, env_id, nr_envs, seed=0, nr_threads=0, device="cpu"):
        if env_id not in ENV_SPECS:
            raise ValueError(f"unknown native env {env_id!r}; known: {sorted(ENV_SPECS)}")
        spec = ENV_SPECS[env_id]
        self._fn = _library(self.PREFIX)
        self._handle = self._fn("create")(env_id.encode(), nr_envs, seed, nr_threads)
        if not self._handle:
            raise ValueError(f"unknown native env {env_id!r}")
        self.env_id = env_id
        self.nr_envs = nr_envs
        self.horizon = self._fn("horizon")(self._handle)
        self._obs_dim = self._fn("obs_dim")(self._handle)
        self.single_observation_space = BoxSpace(low=-np.inf, high=np.inf, shape=(self._obs_dim,), device=device)
        if spec["discrete"]:
            self.single_action_space = DiscreteSpace(spec["nr_actions"], device=device)
        else:
            self.single_action_space = BoxSpace(low=spec["act_low"], high=spec["act_high"],
                                                shape=(spec["act_dim"],), device=device)
        self._init_edge((self._obs_dim,), np.float32, device)

    def _host_reset_into(self, seed, observation):
        # the C++ side keeps each env's random stream from construction on
        self._fn("reset")(self._handle, observation)

    def _host_step_into(self, actions, out):
        actions = np.ascontiguousarray(np.asarray(actions, np.float32).reshape(self.nr_envs, -1))
        self._fn("step")(self._handle, actions, out["observation"], out["final_observation"], out["reward"],
                         out["terminated"].view(np.uint8), out["truncated"].view(np.uint8), out["stats"])

    def close(self):
        if self._handle:
            self._fn("destroy")(self._handle)
            self._handle = None


class MujocoNativeEnvBatch(NativeEnvBatch):
    """C++-vectorized Gymnasium MuJoCo v5 tasks (hopper, half_cheetah,
    walker2d) on the MJCF files that Gymnasium ships."""

    PREFIX = "mjbatch"

    def __init__(self, task, nr_envs, seed=0, nr_threads=0, xml_path=None, device="cpu"):
        self._fn = _library(self.PREFIX)
        path = self._model_path(task, xml_path)
        self._handle = self._fn("create")(path.encode(), task.encode(), nr_envs, seed, nr_threads)
        if not self._handle:
            raise ValueError(f"unknown native {self.PREFIX} task {task!r} (model {path})")
        self.env_id = task
        self.nr_envs = nr_envs
        self.horizon = self._fn("horizon")(self._handle)
        self._obs_dim = self._fn("obs_dim")(self._handle)
        act_dim = self._fn("act_dim")(self._handle)
        lo, hi = np.empty(act_dim, np.float32), np.empty(act_dim, np.float32)
        self._fn("ctrl_range")(self._handle, lo, hi)
        self.single_observation_space = BoxSpace(low=-np.inf, high=np.inf, shape=(self._obs_dim,), device=device)
        self.single_action_space = BoxSpace(low=lo, high=hi, shape=(act_dim,), device=device)
        self._init_edge((self._obs_dim,), np.float32, device)

    @staticmethod
    def _model_path(task, xml_path):
        """Gymnasium's MJCF of ``task`` (walker2d's v5 registration loads
        the revised walker2d_v5.xml)."""
        if xml_path is not None:
            return xml_path
        import gymnasium.envs.mujoco as gm

        filename = "walker2d_v5.xml" if task == "walker2d" else f"{task}.xml"
        return os.path.join(os.path.dirname(os.path.abspath(gm.__file__)), "assets", filename)

    # test hooks
    def set_state(self, env_index, qpos, qvel):
        self._fn("set_state")(self._handle, env_index, np.ascontiguousarray(qpos, np.float64),
                              np.ascontiguousarray(qvel, np.float64))

    def get_state(self, env_index, nq, nv):
        qpos, qvel = np.empty(nq, np.float64), np.empty(nv, np.float64)
        self._fn("get_state")(self._handle, env_index, qpos, qvel)
        return qpos, qvel


class DMCNativeEnvBatch(MujocoNativeEnvBatch):
    """C++-vectorized dm_control suite tasks (cheetah_run, walker_walk,
    walker_run): the reference's EnvPool dmc track."""

    PREFIX = "dmcbatch"

    @staticmethod
    def _model_path(task, xml_path=None):
        """The suite's model of ``task``'s domain (xml and assets from the
        installed dm_control) compiled to a binary ``.mjb`` in the build
        directory, which the C++ side loads without the asset dict."""
        import mujoco

        # dm_control needs a GL backend even without rendering; headless
        # machines lack X11
        os.environ.setdefault("MUJOCO_GL", "egl")
        from dm_control.suite import common

        domain = task.split("_", 1)[0]
        xml = common.read_model(f"{domain}.xml")
        xml = xml.decode() if isinstance(xml, bytes) else xml
        digest = hashlib.sha256((xml + mujoco.__version__).encode()).hexdigest()[:16]
        path = os.path.join(_build.build_dir(), f"dmc_{domain}-{digest}.mjb")
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            mujoco.mj_saveModel(mujoco.MjModel.from_xml_string(xml, common.ASSETS), tmp, None)
            os.replace(tmp, path)
        return path
