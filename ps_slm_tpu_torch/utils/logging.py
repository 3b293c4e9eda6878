"""Console and file logging, a metric sink and parameter counts.

Counterpart of ``ps_slm_tpu/utils/logging.py``: :func:`setup_logger`;
:class:`MetricLogger`, which logs scalars to wandb when the log config
asks for it and wandb imports, else appends JSON lines to
``metrics.jsonl`` beside the log file; :func:`count_params` and
:func:`log_model_size` (parameters per module, trainable ones apart).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, Iterable, Optional


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


class MetricLogger:
    """wandb if enabled and importable, a JSONL sink otherwise."""

    def __init__(self, log_cfg):
        self.cfg = log_cfg
        self._wandb = None
        self._fh = None
        if log_cfg.use_wandb:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                os.makedirs(log_cfg.wandb_dir, exist_ok=True)
                self._wandb = wandb.init(
                    dir=log_cfg.wandb_dir, entity=log_cfg.wandb_entity_name,
                    project=log_cfg.wandb_project_name, name=log_cfg.wandb_exp_name,
                )
        if self._wandb is None:
            path = os.path.join(os.path.dirname(log_cfg.log_file) or ".", "metrics.jsonl")
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        elif self._fh is not None:
            self._fh.write(json.dumps({"step": step, "time": time.time(), **metrics}) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def count_params(params: Iterable) -> int:
    """Elements in ``params`` (tensors)."""
    return int(sum(p.numel() for p in params))


def log_model_size(logger, model, trainable: Optional[Iterable[str]] = None) -> None:
    """One line per top-level module of ``model``: its parameters in
    millions, and of them the trainable ones (names in ``trainable``)."""
    trainable = set(trainable) if trainable is not None else None
    for name, sub in model.named_children():
        named = list(sub.named_parameters(prefix=name))
        if not named:
            continue
        msg = f"module {name}: {count_params(p for _, p in named) / 1e6:.2f}M params"
        if trainable is not None:
            nt = count_params(p for n, p in named if n in trainable)
            msg += f" ({nt / 1e6:.2f}M trainable)"
        logger.info(msg)
