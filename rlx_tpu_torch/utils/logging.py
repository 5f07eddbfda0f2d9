"""Console logging: a box table of metrics per learning iteration (loss/*,
rollout/*, time/sps, ...)."""

import logging
import sys

import numpy as np

rlx_logger = logging.getLogger("rlx_tpu_torch")


def setup_logger():
    """Console handler on stdout (idempotent)."""
    if not rlx_logger.handlers:
        rlx_logger.setLevel(logging.INFO)
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
        rlx_logger.addHandler(handler)
        rlx_logger.propagate = False
    return rlx_logger


class MetricsLogger:
    """Console sink: a box table when ``track_console``, else the step."""

    def __init__(self, track_console=False):
        self.track_console = track_console

    def log_dict(self, metrics, step):
        if not self.track_console:
            rlx_logger.info(f"Step: {step}")
            return
        lines = ["┌" + "─" * 31 + "┬" + "─" * 16 + "┐"]
        for name, value in metrics.items():
            pretty = np.format_float_positional(np.asarray(value), trim="-")
            lines.append(f"│ {name.ljust(30)}│ {str(pretty).ljust(14)[:14]} │")
        lines.append("└" + "─" * 31 + "┴" + "─" * 16 + "┘")
        rlx_logger.info("\n".join(lines))
