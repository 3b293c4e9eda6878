"""Step timing and audio-seconds throughput.

Counterpart of ``ps_slm_tpu/utils/profiler.py::StepTimer``.  The caller
makes the timed work finish before ``stop`` (a device-to-host copy of the
result, or ``torch.cuda.synchronize()``).
"""

from __future__ import annotations

import time
from typing import Optional


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
    def seconds(self) -> float:
        """Seconds of the steps in the window."""
        return sum(self._times)

    @property
    def audio_sec_per_sec(self) -> float:
        t = sum(self._times)
        return sum(self._audio) / t if t else 0.0
