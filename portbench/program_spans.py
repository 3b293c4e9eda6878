"""The program's own spans and counters (``ps_slm_tpu_torch/utils/profiler.py``)
in a traced window.

* :func:`recorded` is what the per-layer readers read: each span path's
  host seconds and calls and the counters, as the program added them while
  the window's profiler ran; ``None`` for a program that has no such
  record.
* :func:`breakdown` reduces the window's profiler events by the program's
  ``tasu.*`` spans: the device's idle gaps, each named by the innermost
  span, the harness's or the program's, over its middle; and the CUDA
  runtime's launch and blocking calls, each put down to the innermost
  ``tasu.*`` span over its start (by time: the autograd engine's thread
  launches the backward while the caller's thread waits in
  ``tasu.backward``; the prefetch thread's copies fall wherever they land),
  and each blocking call to the outermost operator over it in its span
  (``aten::nonzero`` for a boolean mask).

``harness.summarize`` names gaps by the harness's spans alone; until it
reads these, a traced run's breakdown by program span comes from

    python3 -m portbench.program_spans --workload <cell> --seed <n> --seconds <s>

which runs the cell as ``portbench.run`` does (``--trace 1`` unless
``--trace 0``), prints its result line, then one line with the window's
end-to-end rates, the breakdown and the program's record.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Tuple

LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                      "cudaMemsetAsync"})
SYNCS = frozenset({"cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
                   "cudaMemcpy"})


def recorded() -> Optional[Dict]:
    """``{"spans": {path: {"calls", "seconds"}}, "counts": {...}}`` that the
    program recorded while a profiler ran, or ``None`` when it records
    none."""
    try:
        from ps_slm_tpu_torch.utils import profiler
    except ImportError:
        return None
    read = getattr(profiler, "recorded", None)
    return None if read is None else read()


def seconds(rec: Optional[Dict], path: str) -> Optional[float]:
    """Host seconds of a span path in ``rec``; ``None`` when it never ran."""
    v = None if rec is None else rec["spans"].get(path)
    return None if v is None else v["seconds"]


def calls(rec: Optional[Dict], path: str) -> int:
    v = None if rec is None else rec["spans"].get(path)
    return 0 if v is None else v["calls"]


def counted(rec: Optional[Dict], name: str) -> float:
    return 0 if rec is None else rec["counts"].get(name, 0)


def _is_annotation(e) -> bool:
    return "annotation" in str(getattr(e, "activity_type", lambda: "")())


def _covering(spans: List[Tuple[str, int, int]], points: List[int]) -> List[List[str]]:
    """For each of the sorted ``points``, the names of the spans that cover
    it, outermost first (spans of one thread nest)."""
    ordered = sorted(spans, key=lambda s: (s[1], -s[2]))
    out, active, j = [], [], 0
    for t in points:
        while j < len(ordered) and ordered[j][1] <= t:
            active.append(ordered[j])
            j += 1
        active = [s for s in active if s[2] >= t]
        out.append([s[0] for s in active])
    return out


def breakdown(events, window: str = "portbench.window") -> Dict:
    """The window's idle gaps by innermost span, and each ``tasu.*`` span's
    launches and blocking calls (its own and its children's), counted per
    call of the span."""
    dev, host, runtime, ops, win = [], [], [], [], None
    for e in events:
        name, a = e.name(), e.start_ns()
        b = a + e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            if not name.startswith(("portbench.", "tasu.")) and not _is_annotation(e):
                dev.append((a, b))
        elif name == window:
            win = (a, b)
        elif name.startswith(("portbench.", "tasu.")):
            host.append((name[len("portbench."):] if name.startswith("portbench.") else name, a, b))
        elif name in LAUNCHES or name in SYNCS:
            runtime.append((name, a))
        elif name.startswith("aten::"):
            ops.append((name, a, b))
    if win is None:
        raise RuntimeError("the trace has no window span")
    lo, hi = win
    host = [s for s in host if s[2] > lo and s[1] < hi]
    gaps, cur = [], lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in dev if b > lo and a < hi):
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        gaps.append((cur, hi))
    by_gap: Dict[str, float] = {}
    in_step = named_in_step = 0.0
    mids = [(a + b) // 2 for a, b in gaps]
    for (a, b), over in zip(gaps, _covering(host, mids)):
        d = (b - a) * 1e-9
        name = over[-1] if over else "outside harness spans"
        by_gap[name] = by_gap.get(name, 0.0) + d
        if "train.step" in over:
            in_step += d
            named_in_step += d if name.startswith("tasu.") else 0.0
    idle = sum(by_gap.values())
    program = [s for s in host if s[0].startswith("tasu.")]
    per_span: Dict[str, Dict[str, float]] = {}
    for name, a, b in program:
        row = per_span.setdefault(name, {"calls": 0, "host_s": 0.0, "launches": 0, "syncs": 0})
        row["calls"] += 1
        row["host_s"] += (b - a) * 1e-9
    inner: Dict[str, Dict[str, int]] = {}
    runtime = sorted((t, call) for call, t in runtime if lo <= t <= hi)
    for (t, call), over in zip(runtime, _covering(program, [t for t, _ in runtime])):
        kind = "launches" if call in LAUNCHES else "syncs"
        for name in set(over):         # every span over the call, not only the innermost
            per_span[name][kind] += 1
        row = inner.setdefault(over[-1] if over else "outside program spans",
                               {"launches": 0, "syncs": 0})
        row[kind] += 1
    for row in per_span.values():
        row["launches_per_call"] = row["launches"] / row["calls"]
        row["syncs_per_call"] = row["syncs"] / row["calls"]
    syncs = [(t, call) for t, call in runtime if call in SYNCS]
    by_op: Dict[str, Dict[str, int]] = {}
    both = _covering(program + ops, [t for t, _ in syncs])
    for over in both:
        spans = [n for n in over if n.startswith("tasu.")]
        inside = over[over.index(spans[-1]) + 1:] if spans else over
        row = by_op.setdefault(spans[-1] if spans else "outside program spans", {})
        op = inside[0] if inside else "no operator"
        row[op] = row.get(op, 0) + 1
    named = sum(d for n, d in by_gap.items() if n.startswith("tasu."))
    return {"window_s": (hi - lo) * 1e-9, "idle_s": idle,
            "idle_named_by_program_share": named / idle if idle else None,
            "idle_in_train_step_s": in_step,
            "idle_in_train_step_named_share": named_in_step / in_step if in_step else None,
            "idle_gaps": sorted(([n, d] for n, d in by_gap.items()), key=lambda x: -x[1]),
            "spans": per_span, "runtime_by_innermost_span": inner, "syncs_by_operator": by_op}


def main(argv=None) -> int:
    import argparse

    import torch

    from portbench import harness, run

    p = argparse.ArgumentParser(description="a cell's run with its breakdown by program span")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    run._caches()
    torch.set_num_threads(run.HOST_THREADS)
    found = []
    summarize = harness.summarize

    def keep(events, *a, **k):
        found.append(breakdown(events))
        return summarize(events, *a, **k)

    harness.summarize = keep
    out, r = run.execute(args.workload, args.seed, args.seconds, bool(args.trace))
    print(json.dumps(out))
    print(json.dumps({"e2e": r.e2e, "setup_s": r.setup_s, "window_s": r.facts.get("window_s"),
                      "program_breakdown": found[-1] if found else None,
                      "recorded": recorded()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
