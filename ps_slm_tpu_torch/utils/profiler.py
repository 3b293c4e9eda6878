"""Profiler traces, step timing and audio-seconds throughput.

Counterpart of ``ps_slm_tpu/utils/profiler.py``: :func:`trace` records a
``torch.profiler`` trace (host and, on CUDA, device activity) and writes
it as a Chrome trace into ``profile_dir``; :class:`StepTimer` times steps
on the host clock.  The timer measures what the host waited for: the
caller makes the timed work finish before ``stop`` (a device-to-host copy
of the result, or ``torch.cuda.synchronize()``) when it wants device time
in it; the training loop does not, so its rates time dispatch.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(profile_dir: Optional[str]):
    """``with trace("/tmp/profile"):`` records a ``torch.profiler`` trace
    of the block into ``profile_dir/trace.json`` (Chrome trace format);
    nothing when ``profile_dir`` is empty."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


class StepTimer:
    """Rolling step timing + audio-seconds throughput over the last
    ``window`` steps (every step with ``window=None``)."""

    def __init__(self, window: Optional[int] = 50):
        self.window = window
        self.reset()

    def reset(self):
        self._times = []
        self._audio = []
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def stop(self, audio_seconds: float = 0.0):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            self._audio.append(audio_seconds)
            if self.window is not None and len(self._times) > self.window:
                self._times.pop(0)
                self._audio.pop(0)
        self._last = None

    @property
    def steps_per_sec(self) -> float:
        t = sum(self._times)
        return len(self._times) / t if t else 0.0

    @property
    def seconds(self) -> float:
        """Seconds of the steps in the window."""
        return sum(self._times)

    @property
    def audio_sec_per_sec(self) -> float:
        t = sum(self._times)
        return sum(self._audio) / t if t else 0.0
