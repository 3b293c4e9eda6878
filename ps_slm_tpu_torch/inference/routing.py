"""``serve_route=auto``: the serving CLI's choice between the slot pool and
static batching, re-made as completions come in.

A copy of ``ps_slm_tpu/inference/routing.py`` (host code, no device work):

* **cold start on the pool**, which serves unknown completion lengths
  best;
* **segments**: requests go to the current decoder ``probe`` completions
  at a time; the decoder drains and the route is chosen again;
* **length prior**: the median length of the last ``probe`` completions
  (a sliding window, so a workload that drifts re-routes) under
  ``static_below`` favours static batching, else the pool;
* **measured override**: each segment records its completions a second
  (segments shorter than ``MIN_MEASURE_S`` record nothing), tagged with
  its length regime; once both decoders have a rate in the current regime,
  the faster wins by ``MARGIN``; the prior picks which unmeasured decoder
  to explore and breaks near-ties.  A regime change drops the old rates.

Decoders are built once and reused across segments.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

MARGIN = 1.25          # a measured rate must beat the other by this factor
MIN_MEASURE_S = 0.05   # segments shorter than this record no rate


def _segment(it, n: int, state: Dict) -> Iterator:
    """At most ``n`` real requests of ``it``; ``None`` items (a live source
    with nothing ready) pass through uncounted.  Sets
    ``state["exhausted"]`` at the source's end."""
    taken = 0
    while taken < n:
        try:
            item = next(it)
        except StopIteration:
            state["exhausted"] = True
            return
        if item is not None:
            taken += 1
        yield item


def route_serve(
    req_iter: Iterator, make_pool: Callable, make_static: Callable, *, probe: int,
    static_below: int, on_partial=None, log: Optional[Callable[[str], None]] = None,
) -> Iterator[Tuple[str, np.ndarray]]:
    """Serve ``req_iter`` through the pool or static decoders, choosing the
    route again every ``probe`` completions (the module's policy); yields
    ``(key, tokens)`` in completion order."""
    probe = max(int(probe), 1)
    it = iter(req_iter)
    state = {"exhausted": False}
    window: deque = deque(maxlen=probe)
    current = "pool"
    decoders: Dict[str, object] = {}
    # name -> (completions a second, short regime) of its latest timed segment
    rate: Dict[str, Tuple[float, bool]] = {}

    def _get(name: str):
        if name not in decoders:
            decoders[name] = make_pool() if name == "pool" else make_static()
        return decoders[name]

    while not state["exhausted"]:
        dec = _get(current)
        kw = {"on_partial": on_partial} if current == "pool" else {}
        seg_lengths = []
        t0 = time.perf_counter()
        for key, toks in dec.run(_segment(it, probe, state), **kw):
            seg_lengths.append(len(toks))
            window.append(len(toks))
            yield key, toks
        dt = time.perf_counter() - t0
        if seg_lengths and dt >= MIN_MEASURE_S:
            seg_median = sorted(seg_lengths)[len(seg_lengths) // 2]
            rate[current] = (len(seg_lengths) / dt, seg_median < static_below)
        if state["exhausted"]:
            return
        median = sorted(window)[len(window) // 2] if window else 0
        short = median < static_below
        prior = "static" if short else "pool"
        valid = {n: r for n, (r, reg) in rate.items() if reg == short}
        if len(valid) == 2 and max(valid.values()) >= MARGIN * min(valid.values()):
            want = max(valid, key=valid.get)
            why = f"measured {valid[want]:.1f} vs {min(valid.values()):.1f} completions/s"
        elif prior not in valid and valid:
            want, why = prior, f"median completion {median} tok (exploring)"
        else:
            want, why = prior, f"median completion {median} tok"
        if want != current and log is not None:
            log(f"serve_route=auto: {why} over last {len(window)} -> routing to "
                f"{'static batching' if want == 'static' else 'the slot pool'}")
        current = want
