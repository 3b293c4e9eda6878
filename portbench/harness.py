"""What every cell's run shares: the run's record, the port's model built
from the benchmark's weights, the device trace and its reduction, the
per-layer metric files, and the result line.

A driver (``drivers/<kind>.py``, the traffic's ``kind``) fills a
:class:`Run`: its end-to-end metrics, the facts the per-layer readers
read, and the numbers compared with the reference, each with its limit.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Check:
    """One number compared with the reference, and its limit."""
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Run:
    cell: Dict
    cfg: Dict
    mix: Dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float
    workdir: str
    control: Optional[str] = None           # a lower-precision path in the program's place
    setup_s: Optional[float] = None
    e2e: Dict[str, float] = field(default_factory=dict)
    facts: Dict = field(default_factory=dict)
    checks: Dict[str, Check] = field(default_factory=dict)
    readings: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    mem_peak: int = 0
    trace_summary: Optional["TraceSummary"] = None

    @property
    def recipe(self) -> Dict:
        return self.cfg["recipes"][self.mix["recipe"]]

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks.values())

    def setup_done(self) -> None:
        """The end of set-up: every queued kernel done, then the clock.  The
        set-up's objects are moved out of the collector's reach, so that
        no collection of them lands in the window."""
        sync(self.device)
        self.setup_s = time.perf_counter() - self.t0
        gc.collect()
        gc.freeze()


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def free(device) -> None:
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def span(name: str):
    """A host span in the device trace (``portbench.<name>``)."""
    import torch

    return torch.profiler.record_function(f"portbench.{name}")


# ----------------------------------------------------------------------------
# the port's model from the benchmark's weights
# ----------------------------------------------------------------------------

def port_configs(cfg: Dict, recipe: Dict, seed: int, **train_overrides):
    """(TrainConfig, ModelConfig, DataConfig) of the port for a recipe of
    the configuration file."""
    from ps_slm_tpu_torch.config import DataConfig, FbankConfig, ModelConfig, TrainConfig

    tc = TrainConfig(seed=seed, **dict(recipe.get("train_config", {}), **train_overrides))
    mc = ModelConfig(llm_dim=cfg["llm"]["hidden_size"], encoder_dim=cfg["encoder"]["vocab_size"],
                     encoder_projector=cfg["projector"]["kind"],
                     encoder_projector_ds_rate=cfg["projector"]["ds_rate"],
                     llm_config_overrides=dict(cfg["llm"]),
                     encoder_config_overrides={k: v for k, v in cfg["encoder"].items()
                                               if k != "blank_id"})
    dc = DataConfig(fbank=FbankConfig(**recipe.get("fbank", {})),
                    **recipe.get("dataset_config", {}))
    return tc, mc, dc


def build_tasu(cfg: Dict, recipe: Dict, seed: int, weights: Dict, cmvn, device,
               quant_bits: Optional[int] = None, **train_overrides):
    """The port's TASU model through its factory, holding the benchmark's
    weights (``load_state_dict``, as the factory loads a checkpoint), then
    its LLM quantized when the recipe (or ``quant_bits``) asks."""
    import torch

    from ps_slm_tpu_torch.models.quantization import quantize_llm
    from ps_slm_tpu_torch.models.tasu import model_factory

    tc, mc, dc = port_configs(cfg, recipe, seed, **train_overrides)
    bits = quant_bits or (tc.quant_bits if tc.quantization else None)
    build_tc = tc.__class__(**{**tc.__dict__, "quantization": False})
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]
    model = model_factory(build_tc, mc, device=device, dtype=dtype,
                          generator=torch.Generator(device=device).manual_seed(0))
    for part, state in weights.items():
        getattr(model, part).load_state_dict(state)
    if bits:
        quantize_llm(model.llm, bits=bits, group_size=tc.q4_group_size)
    model.cmvn = cmvn
    model.fbank_cfg = dc.fbank
    return model, tc, dc


# ----------------------------------------------------------------------------
# the device trace
# ----------------------------------------------------------------------------

@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]]        # (name, start s, seconds) in the window
    gaps: List[Tuple[str, float]]                  # (host span, seconds) of each idle gap

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(d for n, _, d in self.kernels if match(n))

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, _, d in self.kernels:
            by[name[:120]] = by.get(name[:120], 0.0) + d
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, d in self.gaps:
            by[name] = by.get(name, 0.0) + d
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def summarize(events, window: str = "portbench.window") -> TraceSummary:
    """Reduce the profiler's events: the device's busy time (the union of
    its operations' intervals) inside the window span, its kernels, and
    each idle gap named by the innermost harness span that covers its
    middle."""
    host, dev, win = [], [], None
    for e in events:
        kind = str(e.device_type())
        name = e.name()
        if kind.endswith("CUDA"):
            # the harness's spans are mirrored on the device's timeline as
            # annotations; they are no device work
            if not name.startswith("portbench.") and "annotation" not in str(
                    getattr(e, "activity_type", lambda: "")()):
                dev.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name.startswith("portbench."):
            if name == window:
                win = (e.start_ns(), e.start_ns() + e.duration_ns())
            else:
                host.append((name[len("portbench."):], e.start_ns(), e.start_ns() + e.duration_ns()))
    if win is None:
        raise RuntimeError("the trace has no window span")
    lo, hi = win
    dev = sorted(((n, max(a, lo), min(b, hi)) for n, a, b in dev if b > lo and a < hi),
                 key=lambda x: x[1])
    busy, gaps, cur_end = 0, [], lo
    for _, a, b in dev:
        if a > cur_end:
            gaps.append((cur_end, a))
        if b > cur_end:
            busy += b - max(a, cur_end)
            cur_end = b
    if hi > cur_end:
        gaps.append((cur_end, hi))
    host.sort(key=lambda x: x[1])
    named, active, j = [], [], 0
    for a, b in gaps:                       # in time order
        mid = (a + b) // 2
        while j < len(host) and host[j][1] <= mid:
            active.append(host[j])
            j += 1
        active = [s for s in active if s[2] >= mid]
        inner = max(active, key=lambda s: s[1]) if active else None
        named.append((inner[0] if inner else "outside harness spans", (b - a) * 1e-9))
    kernels = [(n, (a - lo) * 1e-9, (b - a) * 1e-9) for n, a, b in dev]
    return TraceSummary((hi - lo) * 1e-9, busy * 1e-9, kernels, named)


@contextlib.contextmanager
def traced(run: Run):
    """The window, under the profiler when the run traces."""
    import torch

    if not run.trace:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(run.device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    run.trace_summary = summarize(prof.profiler.kineto_results.events())


# ----------------------------------------------------------------------------
# per-layer metrics: one file each, found by name
# ----------------------------------------------------------------------------

def load_metric(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict, cell: str) -> Tuple[List[Dict], List[Dict]]:
    """(end-to-end, per-layer) metrics that ``cell`` reports."""
    def mine(m, e2e_names=None):
        if "workloads" in m:
            return cell in m["workloads"]
        return e2e_names is None or m["moves"] in e2e_names

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    return e2e, [m for m in bench["per_layer"] if mine(m, names)]


def result(run: Run, bench: Dict) -> Dict:
    """The result line's object."""
    import torch

    e2e, layer = cell_metrics(bench, run.cell["name"])
    metrics = {}
    if run.trace:
        for m in layer:
            mod = load_metric(m["name"])
            value = mod.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(run.e2e, setup_s=run.setup_s)
        for m in e2e:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    cuda = torch.device(run.device).type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": int(run.cell.get("chips", 1)), "memory_peak_bytes": int(run.mem_peak)}
    out = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if run.trace and run.trace_summary is not None:
        t = run.trace_summary
        device.update(busy_s=t.busy_s, window_s=t.window_s)
        out["breakdown"] = {"device_ops": t.top_ops(), "idle_gaps": t.top_gaps()}
    out["checks"] = {k: {"value": c.value, "limit": c.limit} for k, c in run.checks.items()}
    return out


def check_lines(run: Run) -> List[str]:
    return [f"check {k}: {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}"
            for k, c in run.checks.items()]


FORBIDDEN = ("jax", "jaxlib", "flax", "ps_slm_tpu")


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    JAX's or the JAX package's, compared whole."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)
