"""Epoch training and evaluation loops.

Counterpart of ``ps_slm_tpu/training/loop.py``, with the same behaviours
on one device or as one process of a mesh (the step's metrics are then
the global batch's on every process):

  * gradient accumulation inside the step (``TrainStep``, optax.MultiSteps
    semantics);
  * metrics stay on the device until a ``log_interval`` point, where the
    pending ones are read (no host sync per step), logged and sent to the
    metric sink; the logged it/s and audio-s/s time the steps from one log
    point's read to the next (an evaluation restarts the clock), so they
    are step rates, not the rates at which steps are queued;
  * ``validation_interval`` evaluation when ``run_validation``; a
    ``step_N`` checkpoint on a new best eval loss when ``save_model``;
    ``last`` at the end when ``save_last``;
  * epoch summaries with the loss, accuracy, time and a ``MemoryTrace``;
  * resume fast-forward: a state restored at micro-step ``state.step``
    skips that many batches of the deterministic stream (``GlobalBatcher``
    with ``seed + epoch``), so the resumed run sees the data and learning
    rates of an uninterrupted one.  A source that takes ``skip_batches``
    yields cheap marker batches (``{"batch_skipped": True}``) or skips
    internally; a source without it is read and dropped; an epoch consumed
    whole before the checkpoint does not run.

Batches reach the device through ``data/prefetch.py::device_prefetch``
(the copy in a producer thread on a side stream).
"""

from __future__ import annotations

import inspect
import itertools
import math
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ps_slm_tpu_torch.data.prefetch import as_tensor, device_prefetch
from ps_slm_tpu_torch.training.step import TrainStep, make_eval_step
from ps_slm_tpu_torch.utils.memory import MemoryTrace
from ps_slm_tpu_torch.utils.profiler import StepTimer, trace

_DEVICE_KEYS = (
    "input_ids", "attention_mask", "labels", "input_features",
    "input_feature_length", "waveform", "waveform_length", "gt_ids",
    "gt_lens", "batch_valid",
)


def device_fields(batch: Dict) -> Dict:
    """The fields of a host batch that the step reads."""
    return {k: v for k, v in batch.items() if k in _DEVICE_KEYS}


def to_device_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The step's fields of a host batch as tensors on ``device``."""
    return {k: as_tensor(v).to(device) for k, v in device_fields(batch).items()}


def _batch_audio_seconds(batch: Dict) -> float:
    """True audio seconds in the batch, without the padded repeat rows
    (``batch_valid`` False): the collator's per-row ``audio_seconds``, else
    the waveforms' samples at 16 kHz, else 60 ms an LFR frame."""
    valid = batch.get("batch_valid")

    def masked_sum(v):
        v = np.asarray(v)
        if valid is not None:
            v = v[np.asarray(valid)]
        return float(np.sum(v))

    if "audio_seconds" in batch:
        return masked_sum(batch["audio_seconds"])
    if "waveform_length" in batch:
        return masked_sum(batch["waveform_length"]) / 16000.0
    if "input_feature_length" in batch:
        return masked_sum(batch["input_feature_length"]) * 0.060
    return 0.0


def evaluate(model, eval_batches: Iterable[Dict], device, eval_step=None) -> Dict[str, float]:
    """Mean loss and accuracy over an eval stream (each batch weighs one)."""
    eval_step = eval_step or make_eval_step(model, device=device)
    tot_loss = tot_acc = 0.0
    n = 0
    for batch in eval_batches:
        m = eval_step(to_device_batch(batch, device))
        tot_loss += float(m["loss"])
        tot_acc += float(m["acc"])
        n += 1
    if n == 0:
        return {"eval_loss": float("nan"), "eval_acc": float("nan")}
    return {
        "eval_loss": tot_loss / n,
        "eval_acc": tot_acc / n,
        "eval_ppl": float(math.exp(min(tot_loss / n, 30.0))),
    }


def _fast_forward(train_batches_fn, epoch: int, global_step: int, resume_step: int):
    """The epoch's source past the batches a resumed run already trained
    on: (source or None when the epoch was consumed whole, the global step
    reached)."""
    need_skip = resume_step - global_step
    src, skip_capable = None, False
    try:
        params = inspect.signature(train_batches_fn).parameters
    except (TypeError, ValueError):
        params = {}
    if "skip_batches" in params:
        # header-only audio lengths and uncollated marker batches
        src, skip_capable = train_batches_fn(epoch, skip_batches=need_skip), True
    else:
        src = train_batches_fn(epoch)
    src = iter(src)
    first, saw_any = None, False
    while global_step < resume_step:
        try:
            b = next(src)
        except StopIteration:
            src = None
            break
        saw_any = True
        if skip_capable and not (isinstance(b, dict) and b.get("batch_skipped")):
            # a source that skipped internally: b is the first real batch
            # after the skip (counting it would skip real data twice)
            first, global_step = b, resume_step
            break
        global_step += 1     # a marker, or a decoded batch dropped
    if src is None and skip_capable and not saw_any:
        # an internal-skip source that yielded nothing says nothing of how
        # many batches the epoch held: count the undoctored stream
        src = iter(train_batches_fn(epoch))
        while global_step < resume_step:
            try:
                next(src)
            except StopIteration:
                src = None
                break
            global_step += 1
    if src is not None and first is None:
        # an epoch whose batches were all consumed before the checkpoint
        # must not run (and log) a zero-batch epoch
        try:
            first = next(src)
        except StopIteration:
            src = None
    if src is not None:
        src = itertools.chain([first], src)
    return src, global_step


def train(
    model,
    state: TrainStep,
    train_config,
    log_config,
    train_batches_fn: Callable[..., Iterable[Dict]],
    eval_batches_fn: Optional[Callable[[], Iterable[Dict]]] = None,
    *,
    logger=None,
    metric_logger=None,
    checkpoint_fn: Optional[Callable] = None,
):
    """Epoch loop on ``state``'s device.  ``train_batches_fn(epoch)`` (or
    ``(epoch, skip_batches=n)``) yields host batches; ``eval_batches_fn()``
    the eval stream; ``checkpoint_fn(state, tag)`` persists.

    Returns (state, history dict).
    """
    device = state.device
    eval_step = make_eval_step(model, device=device) if eval_batches_fn else None
    timer = StepTimer(window=1)     # the steps since the last log point
    best_eval = float("inf")
    history = {"train_loss": [], "eval_loss": []}
    global_step = 0
    log = logger.info if logger else print

    resume_step = state.step
    if resume_step:
        log(f"resume fast-forward: skipping {resume_step} trained batches")

    with trace(log_config.profile_dir):
        for epoch in range(train_config.num_epochs):
            if resume_step > global_step:
                src, global_step = _fast_forward(train_batches_fn, epoch, global_step,
                                                 resume_step)
                if src is None:
                    continue    # the epoch was consumed whole before the checkpoint
            else:
                src = train_batches_fn(epoch)

            epoch_start = time.perf_counter()
            epoch_loss = epoch_acc = 0.0
            epoch_batches = 0
            with MemoryTrace() as mem:
                pending = []  # device metrics, read at log points only
                timer.start()
                timed_steps, timed_audio = 0, 0.0
                for batch, dbatch in device_prefetch(src, device, device_fields, depth=2):
                    metrics = state(dbatch)
                    pending.append(metrics)
                    timed_steps += 1
                    timed_audio += _batch_audio_seconds(batch)
                    epoch_batches += 1
                    global_step += 1

                    if global_step % log_config.log_interval == 0:
                        for m in pending:
                            epoch_loss += float(m["loss"])
                            epoch_acc += float(m["acc"])
                        loss = float(pending[-1]["loss"])
                        acc = float(pending[-1]["acc"])
                        pending = []
                        # the reads waited for the steps' device work
                        timer.stop(timed_audio, steps=timed_steps)
                        timer.start()
                        timed_steps, timed_audio = 0, 0.0
                        log(f"step {global_step} loss {loss:.4f} acc {acc:.4f} "
                            f"{timer.steps_per_sec:.2f} it/s "
                            f"{timer.audio_sec_per_sec:.1f} audio-s/s")
                        if metric_logger:
                            metric_logger.log({
                                "train/loss": loss,
                                "train/acc": acc,
                                "train/steps_per_sec": timer.steps_per_sec,
                                "train/audio_sec_per_sec": timer.audio_sec_per_sec,
                            }, step=global_step)

                    if (train_config.run_validation and eval_batches_fn is not None
                            and global_step % train_config.validation_interval == 0):
                        ev = evaluate(model, eval_batches_fn(), device, eval_step)
                        log(f"eval @ {global_step}: {ev}")
                        if metric_logger:
                            metric_logger.log(ev, step=global_step)
                        history["eval_loss"].append(ev["eval_loss"])
                        if (ev["eval_loss"] < best_eval and checkpoint_fn is not None
                                and train_config.save_model):
                            best_eval = ev["eval_loss"]
                            checkpoint_fn(state, f"step_{global_step}")
                            log(f"checkpoint saved (eval_loss {best_eval:.4f})")
                        timer.start()
                        timed_steps, timed_audio = 0, 0.0

                for m in pending:  # the tail's metrics
                    epoch_loss += float(m["loss"])
                    epoch_acc += float(m["acc"])

            epoch_time = time.perf_counter() - epoch_start
            denom = max(epoch_batches, 1)
            log(f"epoch {epoch}: loss {epoch_loss / denom:.4f} acc {epoch_acc / denom:.4f} "
                f"time {epoch_time:.1f}s; {mem.report()}")
            history["train_loss"].append(epoch_loss / denom)

    if train_config.save_last and checkpoint_fn is not None:
        checkpoint_fn(state, "last")
        log("final checkpoint saved (last/)")
    return state, history
