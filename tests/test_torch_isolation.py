"""The port stands alone: no module of rlx_tpu_torch, and nothing that
chip_smoke.py imports, loads jax or the JAX package.  Every algorithm's
module and every module under ``rlx_tpu_torch/environments/`` is among the
modules imported, the host envs' modules and their 20 registrations named,
the mesh's and the rendering's modules, and the deployment packages, the
playground adapter and the playground registration (the 28th)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECK = r"""
import importlib, os, pkgutil, sys
import rlx_tpu_torch
import rlx_tpu_torch.algorithms
names = [m.name for m in pkgutil.walk_packages(rlx_tpu_torch.__path__, "rlx_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
# chip_smoke imports the package inside main(); those imports are covered
# above, and main() refuses to run without a card
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "rlx_tpu" or m.startswith("rlx_tpu."))
# every algorithm's module (each algorithm directory is a package)
root = os.path.dirname(rlx_tpu_torch.algorithms.__file__)
algorithms = [d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d, "cuda"))]
missing = sorted(({f"rlx_tpu_torch.algorithms.{a}.cuda.{a}" for a in algorithms}
                  | {"rlx_tpu_torch.models.recurrent", "rlx_tpu_torch.algorithms.recurrent_ppo"}) - set(names))
# every module file under environments/ (the robot and soccer envs too)
env_root = os.path.join(os.path.dirname(rlx_tpu_torch.__file__), "environments")
for dirpath, _, files in os.walk(env_root):
    for f in files:
        if f.endswith(".py"):
            rel = os.path.relpath(os.path.join(dirpath, f), os.path.dirname(rlx_tpu_torch.__file__))
            module = "rlx_tpu_torch." + rel[:-3].replace(os.sep, ".")
            module = module[:-len(".__init__")] if module.endswith(".__init__") else module
            if module not in names and module not in sys.modules:
                missing.append(module)
assert "rlx_tpu_torch.environments.locomotion.soccer.cuda.environment" in names
# the mesh and the rendering
assert {"rlx_tpu_torch.parallel.mesh", "rlx_tpu_torch.parallel.partition", "rlx_tpu_torch.parallel.dryrun",
        "rlx_tpu_torch.render.offscreen", "rlx_tpu_torch.render.interactive"} <= set(names)
# deployment and the playground
assert {"rlx_tpu_torch.environments." + m for m in (
    "locomotion.robot.deployment.unitree_go2.run", "locomotion.robot.deployment.unitree_go2.sdk",
    "locomotion.soccer.deployment.convert", "locomotion.soccer.deployment.torch_policy",
    "playground.adapter", "playground.g1_joystick_flat_terrain.cuda")} <= set(names)
registrations = [m for m in names if m.startswith("rlx_tpu_torch.environments.") and m.endswith((".cuda", ".host"))]
assert len(registrations) == 28, registrations   # the JAX package's 8 device and 20 host names
assert {"rlx_tpu_torch.environments.classic.pixel_grid.cuda.environment",
        "rlx_tpu_torch.environments.classic.pixel_chase.cuda.environment"} <= set(names)
# the host envs: the edge, the three bridges, the process pool, the Atari
# stack, the socket env, and every host registration
host = {"rlx_tpu_torch.environments." + m for m in (
    "gym.host_bridge", "gym.process_pool", "gym.common", "gym.atari.common", "gym.atari.wrappers",
    "native.batcher", "native.common", "dmc.host_bridge", "custom_interface.prototype.connection")}
host_registrations = [m for m in names if m.startswith("rlx_tpu_torch.environments.") and m.endswith(".host")]
assert host <= set(names) and len(host_registrations) == 20, (sorted(host - set(names)), host_registrations)
print(len(names), bad, missing)
sys.exit(1 if bad or missing or len(names) < 30 else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", CHECK], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_name_neither_jax_nor_the_jax_package():
    offenders = []
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "rlx_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                words = line.replace(",", " ").split()
                if line.lstrip().startswith(("import ", "from ")) and (
                    "jax" in words or any(w == "rlx_tpu" or w.startswith("rlx_tpu.") for w in words)
                ):
                    offenders.append(f"{path}:{n}: {line.strip()}")
    assert not offenders, offenders
