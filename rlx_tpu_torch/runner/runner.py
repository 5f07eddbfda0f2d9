"""Experiment entry point: train, test and show_config modes.

    python -m rlx_tpu_torch.runner.runner --algorithm.name=ppo.cuda \
        --environment.name=locomotion.ant.cuda --runner.track_console=True \
        --algorithm.nr_steps=64 --runner.save_model=True

    python -m rlx_tpu_torch.runner.runner --runner.mode=test \
        --runner.load_model=runs/rlx_tpu_torch/default/run/models/latest.model

Flags are dotted config keys.  Each value is cast to the type of the
field's default, as the JAX package's ``ml_collections`` flags cast it
(``config.cast_to_field``): ``--algorithm.evaluation_active=false`` is
``False``, ``--runner.run_name=1`` the string ``"1"``,
``--algorithm.learning_rate=1`` the float ``1.0`` and
``--algorithm.policy_hidden_sizes=(64, 64)`` a tuple.  Without
``--algorithm.name`` / ``--environment.name`` the runner trains
``ppo.cuda`` on ``classic.pendulum.cuda``, the JAX runner's defaults.
``--runner.device=cpu`` runs the plain versions of the kernels on the CPU;
the default ``cuda`` runs the CUDA kernels and fails without a card
(``runner/default_config.py``).

Train and test mode make the run directory
``runs/<project_name>/<exp_name>/<run_name or "run">`` under the working
directory, with ``provenance.json``, ``diff.patch`` and, with
``--runner.track_tb=True``, TensorBoard scalars under ``tb/``, and build the model
or, with ``runner.load_model``, load it: the stored algorithm config wins
over the defaults, the ``algorithm.*`` flags given here over both.  The
``runner.*`` and ``environment.*`` keys always come from this command line.

On several cards, one process per card (``parallel/mesh.py``):

    torchrun --nproc-per-node=4 -m rlx_tpu_torch.runner.runner --algorithm.name=ppo.cuda \
        --environment.name=locomotion.ant.cuda --runner.mesh_tp=2

joins the process group (``runner.coordinator_address``, else torchrun's
``MASTER_ADDR`` / ``MASTER_PORT``) and runs the ``runner.mesh_dp`` x
``runner.mesh_tp`` mesh (dp = -1: every rank), each rank on
``cuda:{LOCAL_RANK}``; only rank 0 logs and writes the run directory's
files.  Test mode's ``runner.render_video`` / ``runner.render_interactive``
render a rollout after the test episodes (``render/``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from rlx_tpu_torch.algorithms.algorithm_manager import (
    get_algorithm_general_properties, get_algorithm_model_class,
)
from rlx_tpu_torch.config import create_env, make_config
from rlx_tpu_torch.environments.environment_manager import get_environment_general_properties
from rlx_tpu_torch.parallel import mesh as mesh_lib
from rlx_tpu_torch.runner.runner_mode import RunnerMode
from rlx_tpu_torch.utils.logging import rlx_logger, setup_logger

DEFAULT_ALGORITHM = "ppo.cuda"
DEFAULT_ENVIRONMENT = "classic.pendulum.cuda"


def parse_flags(argv):
    """``--a.b=value`` / ``--a.b value`` -> {"a.b": "value"}; the text is
    cast to the field's type when the config is made."""
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
        flags[key] = value
    return flags


class Runner:
    def __init__(self, argv=None, implementation_package_names=("rlx_tpu_torch",)):
        flags = parse_flags(sys.argv[1:] if argv is None else argv)
        self.algorithm_name = flags.pop("algorithm.name", DEFAULT_ALGORITHM)
        self.environment_name = flags.pop("environment.name", DEFAULT_ENVIRONMENT)
        self.mode = flags.pop("runner.mode", RunnerMode.TRAIN)
        self.explicitly_set_algorithm_params = [k for k in flags if k.startswith("algorithm.")]
        self.model = None
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
        """Train mode returns the trained model, test mode the list of test
        returns, show_config the config; ``self.model`` keeps the model."""
        setup_logger()
        if self.mode != RunnerMode.SHOW_CONFIG:
            # under torchrun: join the process group of the mesh
            mesh_lib.initialize_distributed(self.config.runner.coordinator_address)
        if self.mode == RunnerMode.TRAIN:
            return self._train()
        if self.mode == RunnerMode.TEST:
            return self._test()
        if self.mode == RunnerMode.SHOW_CONFIG:
            return self._show_config()
        raise ValueError(f"Unknown runner mode: {self.mode}")

    def _make_run_path(self):
        runner = self.config.runner
        run_path = Path("runs") / runner.project_name / runner.exp_name / (runner.run_name or "run")
        run_path.mkdir(parents=True, exist_ok=True)
        run_path = str(run_path.resolve())
        if mesh_lib.rank() == 0:
            log_run_provenance(run_path)
        return run_path

    def _make_writer(self, run_path):
        """A ``tensorboardX.SummaryWriter`` into ``<run_path>/tb`` with
        ``runner.track_tb``, else None (``tensorboardX`` is imported only
        then, as the JAX runner does)."""
        if not self.config.runner.track_tb or mesh_lib.rank() != 0:
            return None
        from tensorboardX import SummaryWriter

        return SummaryWriter(os.path.join(run_path, "tb"))

    def _make_model(self, train_env, eval_env, run_path, writer=None):
        model_class = get_algorithm_model_class(self.algorithm_name)()
        if self.config.runner.load_model:
            return model_class.load(self.config, train_env, eval_env, run_path, writer,
                                    self.explicitly_set_algorithm_params)
        return model_class(self.config, train_env, eval_env, run_path, writer)

    def _train(self):
        run_path = self._make_run_path()
        train_env, eval_env = create_env(self.config)
        writer = self._make_writer(run_path)
        try:
            self.model = self._make_model(train_env, eval_env, run_path, writer)
            profile_dir = self.config.runner.profile_dir
            if profile_dir:
                with torch.profiler.profile() as profiler:
                    self.model.train()
                os.makedirs(profile_dir, exist_ok=True)
                profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
            else:
                self.model.train()
        finally:
            close_envs(train_env, eval_env)
            if writer is not None:
                writer.close()
        return self.model

    def _test(self):
        run_path = self._make_run_path()
        train_env, eval_env = create_env(self.config)
        try:
            self.model = self._make_model(train_env, eval_env, run_path)
            returns = self.model.test(self.config.runner.nr_test_episodes)
            self._render(self.model)
        finally:
            close_envs(train_env, eval_env)
        rlx_logger.info(f"test: {len(returns)} episodes, returns {[round(r, 2) for r in returns]}")
        return returns

    def _render(self, model):
        """Test mode's viewers, after ``model.test``: ``runner.render_video``
        writes a clip of env 0 (``render/offscreen.py``),
        ``runner.render_interactive`` opens a window (``render/interactive.py``;
        skipped with a warning where the env has no ``xml_path``)."""
        runner = self.config.runner
        if runner.render_video:
            from rlx_tpu_torch.render import render_rollout

            frames = render_rollout(model, runner.render_video)
            rlx_logger.info(f"rendered {frames} frames to {runner.render_video}")
        if runner.render_interactive:
            from rlx_tpu_torch.render.interactive import watch_rollout

            xml_path = getattr(model.eval_env, "xml_path", None)
            if xml_path is None:
                rlx_logger.warning("runner.render_interactive: env exposes no xml_path; skipping")
            else:
                steps = watch_rollout(model, xml_path)
                rlx_logger.info(f"interactive viewer closed after {steps} steps")

    def _show_config(self):
        rlx_logger.info("\n" + json.dumps(self.config.to_dict(), indent=1))
        return self.config


def close_envs(train_env, eval_env):
    train_env.close()
    if eval_env is not train_env:
        eval_env.close()


def log_run_provenance(run_path):
    """``provenance.json`` (pip freeze, git commit, ``SLURM_JOB_ID``) and
    ``diff.patch`` (the working tree's diff) in the run directory, as the
    JAX package's runner writes them; what cannot be read is left out."""
    provenance = {}
    try:
        packages = subprocess.check_output([sys.executable, "-m", "pip", "freeze"],
                                           stderr=subprocess.DEVNULL, text=True).splitlines()
        provenance["python_packages"] = dict(p.split("==", 1) for p in packages if "==" in p)
    except (OSError, subprocess.CalledProcessError) as e:
        rlx_logger.warning(f"Could not capture pip freeze: {e}")
    project_dir = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        provenance["git_commit_hash"] = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=project_dir, stderr=subprocess.DEVNULL, text=True).strip()
        diff = subprocess.check_output(["git", "diff"], cwd=project_dir, stderr=subprocess.DEVNULL, text=True)
        with open(os.path.join(run_path, "diff.patch"), "w") as f:
            f.write(diff)
    except (OSError, subprocess.CalledProcessError) as e:
        rlx_logger.warning(f"Could not capture git state: {e}")
    if "SLURM_JOB_ID" in os.environ:
        provenance["SLURM_JOB_ID"] = os.environ["SLURM_JOB_ID"]
    with open(os.path.join(run_path, "provenance.json"), "w") as f:
        json.dump(provenance, f, indent=1)


if __name__ == "__main__":
    Runner().run()
