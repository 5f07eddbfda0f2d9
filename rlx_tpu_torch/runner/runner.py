"""Experiment entry point (train mode).

    python -m rlx_tpu_torch.runner.runner --algorithm.name=ppo.cuda \
        --environment.name=locomotion.ant.cuda --runner.track_console=True \
        --algorithm.nr_steps=64

Flags are dotted config keys; values are parsed as Python literals where
they are one (``64``, ``True``, ``(512, 256)``) and kept as strings
otherwise.  ``--runner.device=cpu`` runs the plain versions of the kernels
on the CPU; the default ``cuda`` runs the CUDA kernels.
"""

import ast
import sys

from rlx_tpu_torch.algorithms.algorithm_manager import get_algorithm_general_properties
from rlx_tpu_torch.config import create_model, make_config
from rlx_tpu_torch.environments.environment_manager import get_environment_general_properties
from rlx_tpu_torch.runner.runner_mode import RunnerMode
from rlx_tpu_torch.utils.logging import setup_logger

DEFAULT_ALGORITHM = "ppo.cuda"
DEFAULT_ENVIRONMENT = "locomotion.ant.cuda"


def parse_flags(argv):
    """``--a.b=value`` / ``--a.b value`` -> {"a.b": parsed value}."""
    flags, i = {}, 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise ValueError(f"unexpected argument {arg!r}")
        if "=" in arg:
            key, value = arg[2:].split("=", 1)
            i += 1
        else:
            if i + 1 >= len(argv):
                raise ValueError(f"flag {arg!r} has no value")
            key, value = arg[2:], argv[i + 1]
            i += 2
        try:
            flags[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            flags[key] = value
    return flags


class Runner:
    def __init__(self, argv=None, implementation_package_names=("rlx_tpu_torch",)):
        flags = parse_flags(sys.argv[1:] if argv is None else argv)
        self.algorithm_name = flags.pop("algorithm.name", DEFAULT_ALGORITHM)
        self.environment_name = flags.pop("environment.name", DEFAULT_ENVIRONMENT)
        self.mode = flags.pop("runner.mode", RunnerMode.TRAIN)
        self.config = make_config(self.algorithm_name, self.environment_name,
                                  implementation_package_names, **flags)
        self.check_compatibility(
            get_algorithm_general_properties(self.algorithm_name),
            get_environment_general_properties(self.environment_name),
        )

    @staticmethod
    def check_compatibility(algorithm_properties, environment_properties):
        if environment_properties.action_space_type not in algorithm_properties.action_space_types:
            raise ValueError("algorithm does not support the environment's action space")
        if environment_properties.observation_space_type not in algorithm_properties.observation_space_types:
            raise ValueError("algorithm does not support the environment's observation space")
        if environment_properties.data_interface_type not in algorithm_properties.data_interface_types:
            raise ValueError("algorithm does not support the environment's data interface")

    def run(self):
        if self.mode != RunnerMode.TRAIN:
            raise NotImplementedError(f"runner mode {self.mode!r} is not ported yet (train only)")
        setup_logger()
        model = create_model(self.config)
        try:
            model.train()
        finally:
            model.train_env.close()
        return model


if __name__ == "__main__":
    Runner().run()
