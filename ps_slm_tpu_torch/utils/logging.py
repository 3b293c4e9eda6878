"""Console and file logging.

Counterpart of ``ps_slm_tpu/utils/logging.py::setup_logger``; the metric
sink and the parameter-count helpers come with the training CLI
(ROADMAP.md queue 1, 'Checkpoints and the training CLI').
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional


def setup_logger(
    name: str = "ps_slm", log_file: Optional[str] = None, level: int = logging.INFO,
) -> logging.Logger:
    """A logger writing ``[time][name][level] - message`` lines to stdout
    and, when given, to ``log_file`` (its directory created)."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("[%(asctime)s][%(name)s][%(levelname)s] - %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
