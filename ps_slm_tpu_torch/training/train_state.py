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

Gradient accumulation (``gradient_accumulation_steps`` k > 1) follows
``optax.MultiSteps(adamw, every_k_schedule=k)``: :class:`MultiSteps` keeps
the running mean of the micro-steps' gradients (``acc + (g - acc) / (n +
1)``, optax's update), AdamW steps on every k-th micro-step only, on that
mean, and the parameters do not move in between; the schedule is read at
the count of applied updates (MultiSteps' inner count), not at the
micro-step count.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable

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
    betas, eps and weight decay; the caller sets the lr before each step
    (:class:`MultiSteps` does)."""
    params = list(params)
    if not params:
        raise ValueError("no trainable parameters: every module is frozen")
    # under a mesh, sharded (DTensor) and whole parameters in groups of
    # their own: AdamW's foreach update takes one kind a list
    from torch.distributed.tensor import DTensor

    kinds = ([p for p in params if isinstance(p, DTensor)],
             [p for p in params if not isinstance(p, DTensor)])
    if all(kinds):
        params = [{"params": kind} for kind in kinds]
    return torch.optim.AdamW(
        params, lr=0.0,
        betas=(train_config.adam_beta1, train_config.adam_beta2),
        eps=train_config.adam_eps, weight_decay=train_config.weight_decay,
    )


class MultiSteps:
    """Gradient accumulation over ``every_k`` micro-steps around
    ``optimizer``, with the learning rate of ``schedule`` (optax.MultiSteps
    semantics, module docstring).  Call :meth:`step` after each backward;
    the parameters' ``.grad`` hold that micro-step's gradients."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Callable[[int], float],
                 every_k: int = 1):
        if every_k < 1:
            raise ValueError(f"gradient_accumulation_steps must be >= 1, got {every_k}")
        self.optimizer, self.schedule, self.every_k = optimizer, schedule, every_k
        self.params = [p for group in optimizer.param_groups for p in group["params"]]
        self.mini_step = 0        # micro-steps folded into the running mean
        self.gradient_step = 0    # AdamW updates applied (the schedule's count)
        self.acc = None           # the running mean, one tensor a parameter (None: zeros)

    def step(self) -> bool:
        """Fold this micro-step's gradients in; on the ``every_k``-th, set
        the learning rate at the applied-update count and step AdamW on the
        mean.  Returns whether the parameters moved."""
        if self.every_k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.params]
            for a, p in zip(self.acc, self.params):
                g = torch.zeros_like(p) if p.grad is None else p.grad
                a.add_((g - a) / (self.mini_step + 1))
            if self.mini_step < self.every_k - 1:
                self.mini_step += 1
                return False
            for a, p in zip(self.acc, self.params):
                p.grad = a
            self.acc, self.mini_step = None, 0
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.gradient_step)
        self.optimizer.step()
        self.gradient_step += 1
        return True

    def state_dict(self) -> Dict:
        return {"optimizer": self.optimizer.state_dict(), "mini_step": self.mini_step,
                "gradient_step": self.gradient_step,
                "acc": None if self.acc is None else [a.clone() for a in self.acc]}

    def load_state_dict(self, state: Dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.mini_step, self.gradient_step = state["mini_step"], state["gradient_step"]
        self.acc = None if state["acc"] is None else [
            a.to(p.device, p.dtype) for a, p in zip(state["acc"], self.params)]
