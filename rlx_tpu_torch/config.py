"""Config construction: three namespaces (runner, algorithm, environment)
with dotted overrides, in plain Python.

    make_config("ppo.cuda", "locomotion.ant.cuda", **{"algorithm.nr_steps": 64})

Every override is cast to the type of the field's default, as the JAX
package's ``ml_collections`` config flags cast a command line's values, so
a value given as text (``"64"``, ``"false"``) and one given as a Python
value (``64``, ``False``) set the same field alike.
"""

import ast
import importlib

import torch

from rlx_tpu_torch.algorithms.algorithm_manager import (
    get_algorithm_config, get_algorithm_model_class, registered_algorithm_names,
)
from rlx_tpu_torch.algorithms.parallel_seeds import nr_parallel_seeds, refuse
from rlx_tpu_torch.environments.environment_manager import (
    get_environment_config, get_environment_create_env, registered_environment_names,
)
from rlx_tpu_torch.environments.env import DeviceEnv, shard_env
from rlx_tpu_torch.environments.gym.host_bridge import HostEnv
from rlx_tpu_torch.parallel.mesh import mesh_for, rank_device
from rlx_tpu_torch.runner.default_config import get_config as get_runner_config
from rlx_tpu_torch.utils.config_dict import ConfigDict


def import_for(kind, dotted_name, implementation_package_names=("rlx_tpu_torch",)):
    errors = []
    for pkg in implementation_package_names:
        try:
            importlib.import_module(f"{pkg}.{kind}.{dotted_name}")
            return
        except ModuleNotFoundError as e:
            errors.append(str(e))
    raise ValueError(f"Could not import {kind} '{dotted_name}': {errors}")


def make_config(algorithm_name, environment_name,
                implementation_package_names=("rlx_tpu_torch",), **overrides):
    """Build the merged config; ``overrides`` use dotted keys."""
    if algorithm_name not in registered_algorithm_names():
        import_for("algorithms", algorithm_name, implementation_package_names)
    if environment_name not in registered_environment_names():
        import_for("environments", environment_name, implementation_package_names)

    config = ConfigDict(
        runner=get_runner_config(),
        algorithm=get_algorithm_config(algorithm_name),
        environment=get_environment_config(environment_name),
    )
    apply_overrides(config, overrides)
    return config


# absl's spellings of a boolean flag's value
BOOLEAN_SPELLINGS = {"true": True, "t": True, "1": True, "false": False, "f": False, "0": False}


def cast_to_field(key, default, value):
    """``value`` as the type of ``default``, by ``ml_collections``' rules:

    - bool: a bool, or absl's spellings (``true``/``t``/``1``, ``false``/
      ``f``/``0``, any case); anything else raises;
    - str: the text as it is (``run_name=1`` stays ``"1"``);
    - int: an int, or text that ``int(text, 0)`` reads;
    - float: an int or a float, or text that ``float`` reads;
    - tuple: a list or tuple, or text that is one as a Python literal
      (a single value becomes a 1-tuple).

    A value of another type raises ``TypeError``.
    """
    def mismatch():
        return TypeError(f"{key}: {value!r} does not fit the field's type {type(default).__name__}")

    if isinstance(default, bool):
        if isinstance(value, bool):
            return value
        if isinstance(value, str) and value.lower() in BOOLEAN_SPELLINGS:
            return BOOLEAN_SPELLINGS[value.lower()]
        raise ValueError(f"{key}: {value!r} is not a boolean (true/false, t/f, 1/0)")
    if isinstance(default, str):
        if isinstance(value, str):
            return value
        raise mismatch()
    if isinstance(default, int):
        if isinstance(value, str):
            return int(value, 0)
        if isinstance(value, int) and not isinstance(value, bool):
            return value
        raise mismatch()
    if isinstance(default, float):
        if isinstance(value, str):
            return float(value)
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
        raise mismatch()
    if isinstance(default, tuple):
        if isinstance(value, str):
            try:
                value = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                pass
        return tuple(value) if isinstance(value, (list, tuple)) else (value,)
    return value


def apply_overrides(config, overrides):
    """Set each dotted key, cast to its field's type (``cast_to_field``);
    an unknown key raises ``KeyError``."""
    for dotted_key, value in overrides.items():
        node = config
        parts = dotted_key.split(".")
        for part in parts[:-1]:
            node = node[part]
        node.set_existing(parts[-1], cast_to_field(dotted_key, node.get(parts[-1]), value))


# runner.matmul_precision (the JAX package's jax_default_matmul_precision
# names) -> torch.set_float32_matmul_precision: float32 products, TF32
# products, or bfloat16 products (torch's "medium")
MATMUL_PRECISIONS = {
    "float32": "highest", "highest": "highest",
    "tensorfloat32": "high", "high": "high",
    "bfloat16": "medium", "default": "medium", "fastest": "medium",
}


def set_matmul_precision(config):
    """``torch.set_float32_matmul_precision`` from ``runner.matmul_precision``;
    an unknown name raises ``ValueError``."""
    name = config.runner.matmul_precision
    if name not in MATMUL_PRECISIONS:
        raise ValueError(f"runner.matmul_precision={name!r}: expected one of {sorted(MATMUL_PRECISIONS)}")
    torch.set_float32_matmul_precision(MATMUL_PRECISIONS[name])


def create_env(config):
    """(train env, eval env) on ``runner.device``; a CUDA device that is not
    there raises, it never falls back to the CPU.  On a CUDA device cuDNN's
    convolutions are held to float32 (PyTorch lets them run in TF32 by
    default, unlike its matrix products), so NatureCNN computes in the same
    precision as the JAX reference and the port's Dense layers.  The
    products' precision is ``runner.matmul_precision``'s
    (``set_matmul_precision``: float32 unless asked otherwise).

    With ``algorithm.nr_parallel_seeds = S > 1`` each env holds ``S *
    environment.nr_envs`` envs, seed-major; an env that cannot draw per
    seed (``parallel_seeds`` not set) raises ``NotImplementedError``.

    Under a dp mesh (``parallel/mesh.py``, ``runner.mesh_dp``) each rank's
    envs are its ``nr_envs / dp`` rows of the global batch, on
    ``cuda:{LOCAL_RANK}`` for ``runner.device="cuda"``: a device env draws
    the global draws and keeps its rows (``env.shard_env``), a host env
    seeds its envs as those rows are seeded at dp = 1
    (``environment.first_env``).  Other envs (the robot and soccer envs,
    the socket env) raise ``NotImplementedError`` at dp > 1."""
    device = rank_device(config.runner.device)
    if device != config.runner.device:
        config = ConfigDict(config, runner=ConfigDict(config.runner, device=device))
    mesh = mesh_for(config, device)
    if mesh.dp > 1:
        return _create_dp_envs(config, mesh)
    if config.runner.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"runner.device={config.runner.device!r} but no CUDA device is available; "
                               "pass runner.device=cpu to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
    set_matmul_precision(config)
    nr_seeds = nr_parallel_seeds(config)
    if nr_seeds == 1:
        return get_environment_create_env(config.environment.name)(config)
    seeded = ConfigDict(config, environment=ConfigDict(config.environment,
                                                       nr_envs=config.environment.nr_envs * nr_seeds))
    envs = get_environment_create_env(config.environment.name)(seeded)
    for env in envs:
        if not getattr(env, "parallel_seeds", False):
            for e in envs:
                e.close()
            refuse(config, f"environment {config.environment.name}")
    return envs


def _create_dp_envs(config, mesh):
    """This dp rank's (train env, eval env): its rows of the global batch."""
    if nr_parallel_seeds(config) > 1:
        raise NotImplementedError("nr_parallel_seeds > 1 does not run on a dp mesh (runner.mesh_dp > 1) yet")
    n = config.environment.nr_envs
    first, last = mesh.rows_of_rank(n)
    local = ConfigDict(config, environment=ConfigDict(config.environment, nr_envs=last - first, first_env=first))
    envs = create_env(ConfigDict(local, runner=ConfigDict(local.runner, mesh_dp=1, mesh_tp=1)))
    for env in envs:
        if isinstance(env, HostEnv) and env.nr_envs == last - first:
            continue
        if isinstance(env, DeviceEnv) or getattr(env, "parallel_seeds", False) and hasattr(env, "env"):
            shard_env(env, first, n)
            continue
        for e in envs:
            e.close()
        raise NotImplementedError(f"environment {config.environment.name} does not run on a dp mesh")
    return envs


def create_model(config, train_env=None, eval_env=None, run_path=None, writer=None):
    """The algorithm's model; with ``run_path`` it saves into
    ``<run_path>/models``, and without one ``runner.save_model`` raises."""
    if train_env is None:
        train_env, eval_env = create_env(config)
    model_class = get_algorithm_model_class(config.algorithm.name)()
    return model_class(config, train_env, eval_env, run_path, writer)
