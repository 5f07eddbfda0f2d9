"""Console logging: a box table of metrics per learning iteration (loss/*,
rollout/*, time/sps, ...), and each metric as a TensorBoard scalar when the
runner hands over a writer (``runner.track_tb``)."""

import logging
import sys

import numpy as np

rlx_logger = logging.getLogger("rlx_tpu_torch")


def setup_logger():
    """Console handler on stdout, at INFO (idempotent).  The level is set on
    every call: a handler added by someone else first (a test's, a host
    application's) must not leave the logger at the root's WARNING, which
    drops the runner's INFO lines."""
    rlx_logger.setLevel(logging.INFO)
    if not any(getattr(h, "rlx_console", False) for h in rlx_logger.handlers):
        handler = logging.StreamHandler(sys.stdout)
        handler.rlx_console = True
        handler.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
        rlx_logger.addHandler(handler)
        rlx_logger.propagate = False
    return rlx_logger


class MetricsLogger:
    """Console sink: a box table when ``track_console``, else the step; with
    a ``writer`` (``tensorboardX.SummaryWriter``) every metric is also a
    scalar at ``step``."""

    def __init__(self, track_console=False, writer=None):
        self.track_console = track_console
        self.writer = writer

    def log_dict(self, metrics, step):
        if self.writer is not None:
            for name, value in metrics.items():
                self.writer.add_scalar(name, float(np.asarray(value)), step)
        if not self.track_console:
            rlx_logger.info(f"Step: {step}")
            return
        lines = ["┌" + "─" * 31 + "┬" + "─" * 16 + "┐"]
        for name, value in metrics.items():
            pretty = np.format_float_positional(np.asarray(value), trim="-")
            lines.append(f"│ {name.ljust(30)}│ {str(pretty).ljust(14)[:14]} │")
        lines.append("└" + "─" * 31 + "┴" + "─" * 16 + "┘")
        rlx_logger.info("\n".join(lines))
