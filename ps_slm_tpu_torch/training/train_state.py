"""AdamW with a warmup-cosine schedule over the trainable parameters.

Counterpart of ``ps_slm_tpu/training/train_state.py``.  The JAX package
partitions its parameter tree into trainable and frozen parts and keeps
optax state for the trainable part only; here the freeze flags set
``requires_grad`` (:func:`ps_slm_tpu_torch.models.tasu.trainable_mask`)
and the optimizer is built over the trainable parameters only, so frozen
ones get no gradient and no state.

``torch.optim.AdamW`` computes optax's ``adamw`` update: bias-corrected
moments, eps added outside the square root, and the decoupled weight decay
lr * wd * p taken from the weight before the step.  The learning rate is
set from :func:`warmup_cosine` before each update, at the step count
before it, as optax evaluates its schedule: the first update has lr = 0.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch


def warmup_cosine(
    lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 1e-4
) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, lr, max(warmup, 1),
    max(total, warmup + 1), lr * min_ratio)`` as a function of the step
    (DeepSpeed WarmupCosineLR semantics, conf/ds_config.json)."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1) - warmup
    if decay <= 0:
        raise ValueError(f"warmup_cosine needs total_steps > warmup_steps, got {total_steps}")
    alpha = 0.0 if lr == 0.0 else (lr * min_ratio) / lr

    def schedule(step: int) -> float:
        if step < warmup:
            # optax.linear_schedule(0, lr, warmup), evaluated as optax does
            return (0.0 - lr) * (1 - max(step, 0) / warmup) + lr
        c = min(step - warmup, decay)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay))
        return lr * ((1 - alpha) * cosine + alpha)

    return schedule


def build_optimizer(params: Iterable[torch.nn.Parameter], train_config) -> torch.optim.AdamW:
    """AdamW over ``params`` (the trainable ones only) with the config's
    betas, eps and weight decay; the caller sets the lr before each step."""
    if train_config.gradient_accumulation_steps > 1:
        raise NotImplementedError(
            "gradient_accumulation_steps > 1 (optax.MultiSteps) is not ported "
            "yet (ROADMAP.md queue 1, 'Training options')"
        )
    params = list(params)
    if not params:
        raise ValueError("no trainable parameters: every module is frozen")
    return torch.optim.AdamW(
        params, lr=0.0,
        betas=(train_config.adam_beta1, train_config.adam_beta2),
        eps=train_config.adam_eps, weight_decay=train_config.weight_decay,
    )
