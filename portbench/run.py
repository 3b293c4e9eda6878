"""Run one cell of ``BENCHMARK.json``.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``ps_slm_tpu_torch``.  With
``--trace 0`` the result line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a device trace of the
window.  The last lines on standard error, and the result's last key,
give every number compared with the reference beside its limit.

``--control fp8|half_batch|int4`` reads a limit's upper end instead of
running the benchmark: the reference in fp8, or with half of each batch
left out, in the program's place (training cells); the program's int4
path's first choices at each served position (serving cells).  The build and
kernel caches stay in ``build/`` of the checkout; the stand-in assets go
to a directory under ``TMPDIR`` that the run removes.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_THREADS = 2


def _caches() -> None:
    """Fixed cache directories inside the checkout (only the first run of a
    checkout builds); no library may pull JAX in."""
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def execute(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            control=None, sizes=None, bench=None, t0: float = T0):
    """Run a cell; returns (the result's object, the run)."""
    import importlib

    from portbench import harness, traffic

    bench = bench or harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = harness.load_json(os.path.join(ROOT, conf["file"]))
    mix = traffic.load("traffic", cell["traffic"])
    for part, over in (sizes or {}).items():
        target = cfg if part == "config" else mix if part == "traffic" else cfg.get(part)
        if target is not None:
            target.update(over)
    workdir = tempfile.mkdtemp(prefix="portbench-")
    run = harness.Run(cell=cell, cfg=cfg, mix=mix, seed=seed, seconds=seconds, trace=trace,
                      device=device, t0=t0, workdir=workdir, control=control)
    try:
        importlib.import_module(f"portbench.drivers.{mix['kind']}").run(run)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return harness.result(run, bench), run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("fp8", "half_batch", "int4"), default=None)
    args = p.parse_args(argv)
    _caches()
    import torch

    from portbench import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = next(w for w in bench["workloads"] if w["name"] == args.workload).get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    # one process with few threads: the host paces these cells
    torch.set_num_threads(HOST_THREADS)
    out, run = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                       control=args.control, bench=bench)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"portbench: the run loaded JAX or the JAX package: {', '.join(found)}",
              file=sys.stderr)
        return 4
    print(json.dumps({"readings": run.readings, "setup_s": run.setup_s}), file=sys.stderr)
    for line in harness.check_lines(run):
        print(line, file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
