"""Single-file checkpoints with a config snapshot.

The JAX package's layout (``rlx_tpu/utils/checkpoint.py``):
``<run_path>/models/latest.model`` and ``best.model`` are zip files holding
the checkpoint and ``config_algorithm.json``; loading merges the stored
algorithm config except the keys set explicitly on the command line.

The checkpoint is one ``torch.save`` of a nested dict of CPU tensors and
Python numbers (``checkpoint.pt``), read back with ``weights_only=True``;
the JAX package writes an orbax tree instead, which the port cannot read
(``convert.checkpoint_tree_from_jax`` carries a JAX checkpoint's parameters
across).  A zip is written under ``<save_path>/tmp`` and put in place with
``os.replace``, so a crash never leaves a half-written model file.
"""

import io
import json
import os
import shutil
import zipfile

import torch

from rlx_tpu_torch.parallel import mesh as mesh_lib

CHECKPOINT = "checkpoint.pt"
CONFIG = "config_algorithm.json"


def save_path_for(config, run_path):
    """``<run_path>/models``, or None without a run path; a model that must
    save needs one."""
    if run_path:
        return os.path.join(run_path, "models")
    if config.runner.save_model:
        raise ValueError("runner.save_model needs a run path: create the model with "
                         "create_model(config, run_path=...) or through the Runner")
    return None


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def save_model_file(save_path, file_name, checkpoint_tree, algorithm_config_dict, mesh=None):
    """Write ``<save_path>/<file_name>`` (a zip) atomically.  A checkpoint
    holds one seed's states (seed 0's after a parallel-seed run), so its
    config says ``nr_parallel_seeds = 1``.  On a ``mesh`` of several
    processes only rank 0 writes, and every rank returns once it has."""
    try:
        _write_model_file(save_path, file_name, checkpoint_tree, algorithm_config_dict)
    finally:
        if mesh is not None:
            mesh.barrier()


def _write_model_file(save_path, file_name, checkpoint_tree, algorithm_config_dict):
    if "nr_parallel_seeds" in algorithm_config_dict:
        algorithm_config_dict = {**algorithm_config_dict, "nr_parallel_seeds": 1}
    if save_path is None:
        raise ValueError("the model has no save path: create it with a run path")
    if mesh_lib.rank() != 0:
        return   # in a process group only rank 0 writes (the tree is every rank's)
    tmp_dir = os.path.join(save_path, "tmp")
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir)
    try:
        checkpoint = io.BytesIO()
        torch.save(_to_cpu(checkpoint_tree), checkpoint)
        tmp_file = os.path.join(tmp_dir, file_name)
        with zipfile.ZipFile(tmp_file, "w") as archive:
            archive.writestr(CHECKPOINT, checkpoint.getvalue())
            archive.writestr(CONFIG, json.dumps(algorithm_config_dict))
        os.replace(tmp_file, os.path.join(save_path, file_name))
    finally:
        shutil.rmtree(tmp_dir)


def load_model_file(model_path, mesh=mesh_lib.SINGLE):
    """Read a ``.model`` zip -> (checkpoint_tree on the CPU, algorithm_config_dict).
    On a ``mesh`` of several processes only rank 0 reads the file, and
    every rank gets its bytes (``Mesh.broadcast_bytes``)."""
    data = None
    if mesh_lib.rank() == 0 or mesh.dp * mesh.tp == 1:
        with open(model_path, "rb") as f:
            data = f.read()
    with zipfile.ZipFile(io.BytesIO(mesh.broadcast_bytes(data))) as archive:
        algorithm_config = json.loads(archive.read(CONFIG))
        tree = torch.load(io.BytesIO(archive.read(CHECKPOINT)), weights_only=True, map_location="cpu")
    return tree, algorithm_config


def merge_loaded_algorithm_config(config, loaded_algorithm_config, explicitly_set_algorithm_params):
    """Stored values win unless the flag was set explicitly on the command
    line; keys the config does not have are skipped.  JSON gives lists for
    tuples and may give ints for floats: each is cast back to the config's
    type, as ``ml_collections`` does in the JAX package."""
    for key, value in loaded_algorithm_config.items():
        if f"algorithm.{key}" in explicitly_set_algorithm_params or key not in config.algorithm:
            continue
        current = config.algorithm[key]
        if isinstance(current, tuple) and isinstance(value, list):
            value = tuple(value)
        elif isinstance(current, float) and isinstance(value, int) and not isinstance(value, bool):
            value = float(value)
        config.algorithm[key] = value
    return config


def load_model(model_class, config, train_env, eval_env, run_path, writer, explicitly_set_algorithm_params):
    """``model_class`` built from ``config`` with the stored algorithm config
    of ``runner.load_model`` merged in, then its ``restore_from_tree``.  On
    a dp / tp mesh every rank restores rank 0's file, each into its own
    part: its rows of the per-env states, its slices of tp-split nets."""
    mesh = mesh_lib.mesh_for(config, train_env.device)
    tree, loaded_config = load_model_file(config.runner.load_model, mesh)
    merge_loaded_algorithm_config(config, loaded_config, explicitly_set_algorithm_params)
    model = model_class(config, train_env, eval_env, run_path, writer)
    model.restore_from_tree(tree)
    return model
