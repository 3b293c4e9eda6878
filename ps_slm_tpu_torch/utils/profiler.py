"""Profiler traces, spans and counters, step timing and audio-seconds
throughput.

Counterpart of ``ps_slm_tpu/utils/profiler.py``: :func:`trace` records a
``torch.profiler`` trace (host and, on CUDA, device activity) and writes
it as a Chrome trace into ``profile_dir``; :class:`StepTimer` times steps
on the host clock.  The timer measures what the host waited for: the
caller makes the timed work finish before ``stop`` (a device-to-host copy
of the result, or ``torch.cuda.synchronize()``) when it wants device time
in it; the training loop stops it after reading the metrics of a log
interval, so its rates are step rates.

The port's one tracing facility:

* :func:`span` marks a phase of the program (``tasu.<name>``) as a host
  range of the profiler's trace exactly while some profiler records (this
  module's :func:`trace` or any other ``torch.profiler.profile``); with
  none running it costs one check.  A span sits in the trace on the same
  clock as the CUDA kernels, so an idle gap of the device can be put down
  to the innermost span over it.  It is a function-scope record (as an
  operator's), not a user annotation: the profiler mirrors annotations on
  the device's timeline, where a reader of device time would take them
  for device work.  While recording, each span also adds its host seconds
  to :func:`recorded`, by its path of enclosing spans
  (``step/front_half``).  A span never stays open across a ``yield``.
* :func:`count` adds to one of :data:`COUNTERS`, always; :func:`counts`
  reads them, and :func:`recorded` their part added while a profiler
  recorded.
* :func:`tally` gives one of :data:`TALLIES`: a counter that lives on the
  device, so that work inside a CUDA graph adds to it at each replay with
  no host step (the mixture-of-experts layer's rows by expert).  Its value
  is copied on the device where a profiler starts and stops recording (the
  first span, count or tally after the change), and :func:`recorded` folds
  the difference in when it is read, after the window: the total under
  ``counts`` and the whole array under ``tallies``.  One tally a name a
  process: asked for with another shape or device it starts anew (a CUDA
  graph recorded before then keeps adding to the old one).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Optional

import torch

# the counters, each added where its work happens
COUNTERS = frozenset({
    "pool.requests",      # requests installed in a slot
    "pool.chunks",        # chunks launched
    "pool.slot_steps",    # num_slots x sync_every for each chunk launched
    "pool.tokens",        # tokens kept for a finished request (to its EOS or cap)
    "pool.slot_s",        # host seconds from a request's install to its finish
    "pool.graph_captures",  # chunks recorded as a CUDA graph (one a greedy pool on CUDA)
    "pool.graph_replays",   # chunks launched as a replay of that graph
    "pool.prefill_valid",   # positions of the merged prefills (as the host knows their
                            # length: a row of a stacked front-half call counts the call's)
    "pool.prefill_padded",  # positions of left padding up to the pool's prefill bucket
    "pool.front_half_calls",  # front-half calls a refill makes (one a stack of requests)
    "pool.front_half_rows",   # requests in those calls
})
# the device tallies (utils/profiler.py::tally), each added where its work happens
TALLIES = frozenset({
    "moe.rows",           # [2, layers, experts] (token, choice) pairs routed to each
                          # expert; [0] one-token steps, [1] the other calls
    "moe.experts_read",   # [2, layers] experts with at least one pair, summed over calls
})

_OFF = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast
_counts: Dict[str, float] = {}
_recorded_counts: Dict[str, float] = {}
_recorded_spans: Dict[str, list] = {}        # path -> [calls, host seconds]
_lock = threading.Lock()
_open = threading.local()                    # each thread's open span paths
_tallies: Dict[str, torch.Tensor] = {}
_tally_start: Dict[str, torch.Tensor] = {}   # each tally where recording last started
_tally_done: Dict[str, torch.Tensor] = {}    # each tally's part added while recording, so far
_recording = [False]                         # whether a profiler recorded at the last look


def _since_start(name: str, t: torch.Tensor) -> torch.Tensor:
    base = _tally_start.get(name)
    if base is None or base.shape != t.shape or base.device != t.device:
        return t.clone()
    return t - base


def _look(on: bool) -> None:
    """Copy the tallies on the device where recording starts, and add what
    was added since to the recorded part where it stops."""
    if on == _recording[0]:
        return
    with _lock:
        if on == _recording[0]:
            return
        _recording[0] = on
        if on:
            _tally_start.clear()
            _tally_start.update({n: t.clone() for n, t in _tallies.items()})
            return
        for name, t in _tallies.items():
            part = _since_start(name, t)
            done = _tally_done.get(name)
            same = done is not None and done.shape == part.shape and done.device == part.device
            _tally_done[name] = done + part if same else part


class _Span:
    __slots__ = ("name", "path", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "paths", None)
        if stack is None:
            stack = _open.paths = []
        self.path = f"{stack[-1]}/{self.name}" if stack else self.name
        stack.append(self.path)
        self.range = _Range(f"tasu.{self.name}")
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        _open.paths.pop()
        with _lock:
            acc = _recorded_spans.setdefault(self.path, [0, 0.0])
            acc[0] += 1
            acc[1] += seconds
        return False


def span(name: str):
    """``with span("pool.launch"):`` marks a phase as ``tasu.<name>`` in
    any running profiler's trace; a shared no-op context when none
    records."""
    on = _profiling()
    if on is not _recording[0]:
        _look(on)
    if not on:
        return _OFF
    return _Span(name)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` (one of :data:`COUNTERS`)."""
    if name not in COUNTERS:
        raise KeyError(f"no counter {name!r}; the counters are {sorted(COUNTERS)}")
    on = _profiling()
    _look(on)
    with _lock:
        _counts[name] = _counts.get(name, 0) + n
        if on:
            _recorded_counts[name] = _recorded_counts.get(name, 0) + n


def tally(name: str, shape, device) -> torch.Tensor:
    """The device tally ``name`` (one of :data:`TALLIES`), int64 of
    ``shape`` on ``device``, for the caller to add to in place."""
    if name not in TALLIES:
        raise KeyError(f"no tally {name!r}; the tallies are {sorted(TALLIES)}")
    _look(_profiling())
    t = _tallies.get(name)
    if t is None or tuple(t.shape) != tuple(shape) or t.device != torch.device(device):
        t = _tallies[name] = torch.zeros(tuple(shape), dtype=torch.long, device=device)
    return t


def _recorded_tallies() -> Dict[str, torch.Tensor]:
    """Each tally's part added while a profiler recorded (host tensors)."""
    _look(_profiling())
    with _lock:
        out = dict(_tally_done)
        if _recording[0]:
            for name, t in _tallies.items():
                part = _since_start(name, t)
                done = out.get(name)
                out[name] = done + part if done is not None and done.shape == part.shape \
                    else part
    return {name: t.cpu() for name, t in out.items()}


def counts() -> Dict[str, float]:
    """The counters' totals in this process."""
    with _lock:
        return dict(_counts)


def recorded() -> Dict[str, Dict]:
    """What this process added while a profiler recorded: ``{"spans":
    {path: {"calls", "seconds"}}, "counts": {name: total}, "tallies":
    {name: nested list}}``, host seconds by span path
    (``pool.refill/front_half``); each device tally's total is among the
    counts too."""
    tallies = _recorded_tallies()
    with _lock:
        out = {"spans": {p: {"calls": c, "seconds": s} for p, (c, s) in _recorded_spans.items()},
               "counts": dict(_recorded_counts), "tallies": {}}
    for name, t in tallies.items():
        out["counts"][name] = float(t.sum())
        out["tallies"][name] = t.tolist()
    return out


def _change(after: Dict[str, float], before: Dict[str, float]) -> Dict[str, float]:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


@contextlib.contextmanager
def trace(profile_dir: Optional[str]):
    """``with trace("/tmp/profile"):`` records a ``torch.profiler`` trace
    of the block into ``profile_dir/trace.json`` (Chrome trace format,
    the ``tasu.*`` spans among its host events) and, beside it,
    ``counters.json``: the counters' change over the block and each span
    path's calls and host seconds in it.  Nothing when ``profile_dir`` is
    empty."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    before, spans_before = counts(), recorded()["spans"]
    with profile(activities=activities) as prof:
        yield
    spans = {}
    for path, v in recorded()["spans"].items():
        old = spans_before.get(path, {"calls": 0, "seconds": 0.0})
        if v["calls"] > old["calls"]:
            spans[path] = {"calls": v["calls"] - old["calls"],
                           "seconds": v["seconds"] - old["seconds"]}
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    with open(os.path.join(profile_dir, "counters.json"), "w") as f:
        json.dump({"counters": _change(counts(), before), "spans": spans}, f, indent=1,
                  sort_keys=True)


class StepTimer:
    """Rolling step timing + audio-seconds throughput over the last
    ``window`` timed intervals (every interval with ``window=None``); an
    interval may hold several steps (``stop(..., steps=n)``)."""

    def __init__(self, window: Optional[int] = 50):
        self.window = window
        self.reset()

    def reset(self):
        self._times = []
        self._audio = []
        self._steps = []
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def stop(self, audio_seconds: float = 0.0, steps: int = 1):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            self._audio.append(audio_seconds)
            self._steps.append(steps)
            if self.window is not None and len(self._times) > self.window:
                self._times.pop(0)
                self._audio.pop(0)
                self._steps.pop(0)
        self._last = None

    @property
    def steps_per_sec(self) -> float:
        t = sum(self._times)
        return sum(self._steps) / t if t else 0.0

    @property
    def seconds(self) -> float:
        """Seconds of the intervals in the window."""
        return sum(self._times)

    @property
    def audio_sec_per_sec(self) -> float:
        t = sum(self._times)
        return sum(self._audio) / t if t else 0.0
