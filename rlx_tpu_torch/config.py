"""Config construction: three namespaces (runner, algorithm, environment)
with dotted overrides, in plain Python.

    make_config("ppo.cuda", "locomotion.ant.cuda", **{"algorithm.nr_steps": 64})
"""

import importlib

from rlx_tpu_torch.algorithms.algorithm_manager import (
    get_algorithm_config, get_algorithm_model_class, registered_algorithm_names,
)
from rlx_tpu_torch.environments.environment_manager import (
    get_environment_config, get_environment_create_env, registered_environment_names,
)
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


def apply_overrides(config, overrides):
    for dotted_key, value in overrides.items():
        node = config
        parts = dotted_key.split(".")
        for part in parts[:-1]:
            node = node[part]
        node.set_existing(parts[-1], value)


def create_env(config):
    return get_environment_create_env(config.environment.name)(config)


def create_model(config, train_env=None, eval_env=None, run_path=None, writer=None):
    """The algorithm's model; with ``run_path`` it saves into
    ``<run_path>/models``, and without one ``runner.save_model`` raises."""
    if train_env is None:
        train_env, eval_env = create_env(config)
    model_class = get_algorithm_model_class(config.algorithm.name)()
    return model_class(config, train_env, eval_env, run_path, writer)
