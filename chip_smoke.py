#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ps_slm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run:

1. card: name and power limit from nvidia-smi; TF32 off for comparisons;
2. build: nvcc builds every kernel from ``ps_slm_tpu_torch/csrc`` into
   ``build/ps_slm_tpu_torch/`` (one nvcc per source, in parallel); then,
   for each flash wrapper and dtype, the kernel it launches, its route
   (tensor cores or fp32 FMA), ptxas's registers and spills and the
   tensor-core instructions (HMMA) in its SASS (``cuobjdump``); a
   tensor-core kernel that spills or has no HMMA fails the run; the
   LayerNorm backward kernel's registers and spills; and those of every
   RMSNorm kernel (both routes, each dtype and chunks a lane, with and
   without dw), where a spill in a bf16 vectorised kernel fails the run;
3. kernels: each kernel against its plain PyTorch version at the main
   paths' shapes, in fp32 and bf16, with its time, the plain version's,
   one PyTorch library call's, and the least time the card could take:
   the forward kernels at the serving shapes, the backward kernels (flash
   dq/dkv, LayerNorm and RMSNorm backward) at the training shapes, plus
   a ragged flash case with a left-padded row and a row with no valid key
   (its library time from SDPA with a boolean mask of the same windows),
   and dq + dk/dv together against SDPA's whole backward; the RMSNorm
   backward with dw and with frozen weights (the training main path's
   call), each against ``F.rms_norm``'s autograd backward with the weight
   trained or frozen; the route each RMSNorm call took, where a main-path
   shape off the vectorised route fails the run;
4. serving path, fp32, full width at reduced depth: merged embeddings,
   prefill logits and 8 greedy tokens for the serving batch on the card
   against the same model on the CPU (plain versions);
4b. training path, fp32, full width at reduced depth: two training steps
   of the half_audio recipe on a ragged 5-utterance batch on the card and
   on the CPU: loss, accuracy and token count per step, the projector
   after the second step, the projector moved and the frozen weights
   bit-identical;
5. serving main path, bf16, full width (SenseVoiceSmall + linear-silu +
   Qwen2.5-1.5B, random weights from a seed): ``generate`` on 4
   utterances, with every kernel's launch count and the decode steps
   counted around the call (every RMSNorm launch on the vectorised
   route); then ``generate`` again under
   ``torch.profiler`` (device activity only) for the device-busy share;
5b. training main path, bf16, the same model, at bench.py's batch (5 x
   512 frames, 32 text tokens): 3 warm-up and 10 timed steps of
   ``make_train_step`` with every kernel's launches per step checked
   exactly (every RMSNorm launch on the vectorised route), step ms, audio-sec/s and MFU, peak memory; one step under
   ``torch.profiler``;
6. one JSON line listing every kernel, then the contract line
   ``{"ok": true, "device": {...}}`` last.

Exits non-zero without a result when CUDA is absent or when the
``ps_slm_tpu_torch`` package is not beside this file.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

LFR_FRAME_SEC = 0.06    # one LFR frame: 6 x 10 ms shift
# the serving batch: 4 utterances of LFR frames, a prompt with the speech
# token at position 3, greedy decoding of MAX_NEW tokens
FRAMES = (512, 400, 300, 256)
TEXT_LEN = 32
MAX_NEW = 32
SPEECH_TOKEN = 151934   # vocab - 2, as bench.py
EOS = 151645            # <|im_end|>
# kernel launches per LLM forward (28 layers x 2 + the final norm) and per
# generate call (70 encoder + 28 prefill flash calls; 142 encoder + 1
# projector LayerNorms)
RMS_PER_FORWARD = 57
FLASH_PER_GENERATE = 98
LN_PER_GENERATE = 143
# the training batch is bench.py's (config.BENCH_*): 5 utterances of 512
# LFR frames, 32 text tokens with the speech token at 3 and the first 8
# labels ignored; 3 warm-up and 10 timed steps
TRAIN_RAGGED_FRAMES = (512, 400, 300, 256, 200)   # the fp32 card-vs-CPU phase
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
# kernel launches per training step: the frozen encoder runs forward only,
# the gathered CE back-propagates through the final norm, the 28 LLM
# layers and the projector's LayerNorm
LAUNCHES_PER_TRAIN_STEP = {
    "flash_attention_fwd": 98, "flash_attention_dq": 28, "flash_attention_dkv": 28,
    "layer_norm_fwd": 143, "layer_norm_bwd": 1, "rms_norm_fwd": 57, "rms_norm_bwd": 57,
}

# H100 SXM published peaks (NVIDIA H100 datasheet): memory and the
# rate for the inputs' type (bf16 tensor cores; fp32 outside them)
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

# the kernel each flash wrapper launches for each dtype (the dtype alone
# decides), by the part of its mangled name that tells it apart, and its
# route; the dk/dv tensor-core kernel's partial sums are added by
# dkv_reduce_kernel
FLASH_PATHS = {
    "flash_attention_fwd": (("bf16", "flash_fwd_bf16_kernel", "tensor cores"),
                            ("f32", "flash_fwd_f32_kernel", "fp32 FMA")),
    "flash_attention_dq": (("bf16", "flash_dq_bf16_kernel", "tensor cores"),
                           ("f32", "flash_dq_kernelIf", "fp32 FMA")),
    "flash_attention_dkv": (("bf16", "flash_dkv_bf16_kernel", "tensor cores"),
                            ("bf16", "dkv_reduce_kernel", "sum of the partials"),
                            ("f32", "flash_dkv_f32_kernel", "fp32 FMA")),
}

# the RMSNorm kernels in ptxas's report, by mangled name: the kernel, its
# element type, 16-byte chunks a lane (vectorised route) and whether it
# computes dw
RMS_KERNEL = re.compile(r"(rms_norm_(?:fwd|bwd)(?:_vec)?_kernel|rms_dw_sum_kernel)"
                        r"I(13__nv_bfloat16|f)(?:Li(\d+)E)?(?:Lb([01])E)?")
# RMSNorm shapes of the main paths ([rows, d], bf16): they must take the
# vectorised route
RMS_MAIN_SHAPES = {"rms_norm_fwd": ((2172, 1536), (4, 1536)), "rms_norm_bwd": ((2715, 1536),)}

# kernel vs plain version on the card: |a - b| <= atol + rtol * |b|
KERNEL_TOL = {"f32": (2e-5, 2e-5), "bf16": (1e-2, 1e-2)}
# fp32 whole path, card vs CPU (matmul and reduction order differ)
PATH_TOL = 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def train_batch(torch, input_size: int, frames, seed: int = 0) -> dict:
    """bench.py's training batch for ``frames``: from numpy with ``seed``,
    ids in [1, 1000) with the speech token at 3, labels = ids with the
    first 8 ignored, normal LFR features padded to the longest row; on the
    CPU.  With 5 x 512 frames and seed 0 it is bench.py's batch."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b, a = len(frames), max(frames)
    ids = rng.integers(1, 1000, size=(b, TEXT_LEN))
    ids[:, 3] = SPEECH_TOKEN
    labels = ids.copy()
    labels[:, :8] = -100
    feats = rng.normal(size=(b, a, input_size)).astype(np.float32)
    return {
        "input_ids": torch.from_numpy(ids),
        "attention_mask": torch.ones(b, TEXT_LEN, dtype=torch.bool),
        "labels": torch.from_numpy(labels),
        "input_features": torch.from_numpy(feats),
        "input_feature_length": torch.tensor(list(frames)),
    }


def serving_batch(torch, input_size: int, seed: int = 2) -> dict:
    """:func:`train_batch` for the serving batch's FRAMES, without labels."""
    batch = train_batch(torch, input_size, FRAMES, seed)
    del batch["labels"]
    return batch


@contextlib.contextmanager
def counting_steps():
    """Record the host time at which each decode step of ``greedy_generate``
    starts, by wrapping its ``_step``: the decode steps are counted without
    the kernels' launch counters."""
    from ps_slm_tpu_torch.inference import generate as gen

    real = gen._step
    starts: list = []

    def step(*args, **kwargs):
        starts.append(time.perf_counter())
        return real(*args, **kwargs)

    gen._step = step
    try:
        yield starts
    finally:
        gen._step = real


def loop_steps(tokens, max_new: int) -> int:
    """Decode steps the greedy loop must take for these output tokens: one
    per column after the first, until every row has emitted EOS."""
    ends = [int((row == EOS).nonzero()[0]) if bool((row == EOS).any()) else max_new
            for row in tokens]
    return min(max_new - 1, max(ends))


def real_tokens(tokens, steps: int) -> int:
    """Tokens the rows really generated: up to and including each row's
    first EOS, leaving out the EOS filler of rows that had finished."""
    return sum(int((row == EOS).nonzero()[0]) + 1 if bool((row == EOS).any()) else steps + 1
               for row in tokens)


def profiled(torch, fn):
    """Run ``fn`` once under ``torch.profiler`` with device activity only
    (no host operators are recorded, which keeps the host slow-down small).
    Returns the run's own wall ms, its device-busy ms (the kernels', copies'
    and memsets' durations, summed; one stream, so they do not overlap;
    None when the profiler saw no device activity), the number of device
    operations and the largest items by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            agg = by_name.setdefault(e.name, [0.0, 0])
            agg[0] += e.time_range.elapsed_us() / 1e3
            agg[1] += 1
    busy_ms = sum(v[0] for v in by_name.values()) if by_name else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return wall_ms, busy_ms, sum(v[1] for v in by_name.values()), \
        [[name[:60], ms, n] for name, (ms, n) in top]


def time_ms(torch, fn, iters: int = 20) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph,
    replayed between two events, so the host's launch cost (which bounds
    back-to-back eager calls of a small kernel) is left out.  Inputs stay
    in L2 between the calls when they fit in it (50 MB)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def eager_ms(torch, fn, iters: int = 20) -> float:
    """Time of one call issued back to back from Python: for a small
    kernel this is the host's cost of the call, not the device's."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def backward_ms(torch, fwd, inputs, grad_out):
    """Device ms of the autograd backward of one PyTorch call: forward and
    backward captured together in a CUDA graph, less the forward alone.
    Returns (ms, method); where autograd cannot be captured, the backward
    alone is timed with events around eager calls (host cost included)."""
    def both():
        torch.autograd.grad(fwd(), inputs, grad_out)

    try:
        with torch.no_grad():
            fwd_ms = time_ms(torch, fwd)
        return time_ms(torch, both) - fwd_ms, "graph (forward+backward) - graph (forward)"
    except RuntimeError as e:
        print(f"backward_ms: capture failed ({str(e)[:80]}); timing eager calls", flush=True)
        out = fwd()
        return eager_ms(torch, lambda: torch.autograd.grad(
            out, inputs, grad_out, retain_graph=True)), "events around eager backward calls"


def bound(bytes_moved: float, flops: float, dt: str):
    t_bytes = bytes_moved / MEM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, got, want, dt: str, what: str, scale: float = 1.0) -> float:
    """Max abs error of a kernel's output against its plain version; fails
    beyond ``KERNEL_TOL[dt]``, its atol times ``scale`` (weight gradients,
    summed over n rows, take sqrt(n)), or on any NaN."""
    atol, rtol = KERNEL_TOL[dt]
    atol *= scale
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    if torch.isnan(got).any() or not bool(((got - want).abs() <= atol + rtol * want.abs()).all()):
        fail(f"{what}: kernel disagrees with its plain version (max abs err {err})")
    return err


def ptxas_report(logs: dict) -> dict:
    """{mangled kernel name: [registers, spill bytes stored + loaded]} from
    the nvcc logs of ``_build.build_all`` (``-Xptxas -v``)."""
    report, fn = {}, None
    for line in "\n".join(logs.values()).splitlines():
        words = line.split()
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            report[fn] = [None, None]
        elif fn and "spill stores" in line:       # stack, stores, loads
            nums = [int(w) for w in words if w.isdigit()]
            report[fn][1] = nums[1] + nums[2]
        elif fn and "Used" in words and "registers," in words:
            report[fn][0] = int(words[words.index("Used") + 1])
    return report


def sass_hmma(lib_paths) -> dict:
    """{mangled kernel name: tensor-core (HMMA) instructions in its SASS}
    over the libraries, from ``cuobjdump -sass``; None without cuobjdump."""
    import shutil

    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(exe):
        return None
    counts, fn = {}, None
    for path in lib_paths:
        out = subprocess.run([exe, "-sass", path], capture_output=True, text=True,
                             timeout=120, check=True).stdout
        for line in out.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = 0
            elif fn and "HMMA" in line:
                counts[fn] += 1
    return counts


def phase_paths(logs: dict) -> None:
    """For each flash wrapper and dtype: the kernel, its route, ptxas's
    registers and spills (when this run built it) and its HMMA count.
    Fails if a tensor-core kernel spills or has no HMMA, or an FMA
    kernel has any."""
    from ps_slm_tpu_torch import _build

    report = ptxas_report(logs)
    hmma = sass_hmma([_build._lib_path(src) for src in ("flash_fwd", "flash_bwd")])
    for wrapper, paths in FLASH_PATHS.items():
        for dt, key, route in paths:
            regs, spill = next((v for n, v in report.items() if key in n), (None, None))
            n_hmma = None if hmma is None else next(
                (c for n, c in hmma.items() if key in n), None)
            ptxas = ("ptxas: not measured (library built before this run)" if regs is None
                     else f"ptxas: {regs} registers, {spill} bytes spilled")
            sass = "not measured" if n_hmma is None else str(n_hmma)
            print(f"path {wrapper} {dt}: {key} ({route}); {ptxas}; HMMA in SASS {sass}",
                  flush=True)
            if route == "tensor cores" and (spill or n_hmma == 0):
                fail(f"{wrapper} {dt}: the tensor-core kernel spills or has no HMMA")
            if route == "fp32 FMA" and n_hmma:
                fail(f"{wrapper} {dt}: the FMA kernel has HMMA")
    for key in ("layer_norm_bwd_kernelI13__nv_bfloat16", "layer_norm_bwd_kernelIf"):
        name = next((n for n in report if key in n), None)
        regs, spill = report[name] if name else (None, None)
        ptxas = ("ptxas: not measured (library built before this run)" if regs is None
                 else f"ptxas: {regs} registers, {spill} bytes spilled")
        print(f"path layer_norm_bwd: {key}; {ptxas}; dynamic shared memory 2 x 4 x d bytes "
              f"(200440 at d = 25055)", flush=True)
    rms = sorted(((m.groups(), v) for n, v in report.items() if (m := RMS_KERNEL.search(n))),
                 key=lambda kv: tuple(g or "" for g in kv[0]))
    if not rms:
        print("path rms_norm: ptxas: not measured (library built before this run)", flush=True)
    for (kernel, ty, chunks, wg), (regs, spill) in rms:
        dt = "bf16" if ty.endswith("bfloat16") else "f32"
        what = ", ".join([dt] + ([f"{chunks} chunks a lane"] if chunks else [])
                         + ([{"1": "dw", "0": "no dw"}[wg]] if wg else []))
        print(f"path rms_norm: {kernel} ({what}); ptxas: {regs} registers, {spill} bytes "
              f"spilled", flush=True)
        if "_vec_" in kernel and dt == "bf16" and spill:
            fail(f"{kernel} ({what}): a bf16 vectorised RMSNorm kernel spills")


def rms_route_taken(name, routes, before, n, d, dt) -> str:
    """", route ..." for the log line of an RMSNorm call that moved its
    route counters from ``before`` (empty for other kernels); fails where a
    main-path shape in bf16 did not take the vectorised route."""
    if routes is None:
        return ""
    moved = [r for r in routes if routes[r] != before[r]]
    if dt == "bf16" and (n, d) in RMS_MAIN_SHAPES[name] and moved != ["vec"]:
        fail(f"{name} [{n},{d}] bf16: a main-path shape took the route {moved}, not 'vec'")
    return f", route {'/'.join(moved)}"


def phase_kernels(torch, dev, results):
    import torch.nn.functional as F

    from ps_slm_tpu_torch.ops import flash_attention as fa
    from ps_slm_tpu_torch.ops import norms

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    g = torch.Generator(device=dev).manual_seed(0)

    def entry(name):
        return results.setdefault(name, {"max_abs_err": 0.0, "shapes": []})

    # flash: encoder (non-causal, right-padded) and LLM prefill (causal GQA,
    # left-padded) shapes of the main path
    flash_cases = [
        ("encoder", 4, 516, 4, 4, False, [0, 0, 0, 0], [516, 404, 304, 260]),
        ("llm_prefill", 4, 543, 12, 2, True, [0, 112, 212, 256], [543] * 4),
    ]
    for label, b, s, hq, hkv, causal, starts, ends in flash_cases:
        d = fa.HEAD_DIM
        start = torch.tensor(starts, dtype=torch.int32, device=dev)
        end = torch.tensor(ends, dtype=torch.int32, device=dev)
        pos = torch.arange(s, device=dev)
        valid = (pos[None] >= start[:, None]) & (pos[None] < end[:, None])   # [B,T]
        mask = valid[:, None, None, :].expand(b, 1, s, s)
        if causal:
            mask = mask & (pos[None, :] <= pos[:, None])[None, None]
        pairs = float(mask.sum()) * hq                          # valid (q, k) pairs
        for dt, dtype in dtypes.items():
            q = torch.randn(b, s, hq, d, device=dev, generator=g).to(dtype)
            k = torch.randn(b, s, hkv, d, device=dev, generator=g).to(dtype)
            v = torch.randn(b, s, hkv, d, device=dev, generator=g).to(dtype)
            scale = d ** -0.5
            out, lse = fa.flash_attention_fwd(q, k, v, start, end, causal=causal, scale=scale)
            torch.cuda.synchronize()
            r_out, r_lse = fa.flash_attention_ref(q, k, v, start, end, causal=causal, scale=scale)
            err = max(compare(torch, out, r_out, dt, f"flash {label} {dt} out"),
                      compare(torch, lse, r_lse, "f32", f"flash {label} {dt} lse"))
            ms = time_ms(torch, lambda: fa.flash_attention_fwd(
                q, k, v, start, end, causal=causal, scale=scale))
            plain = time_ms(torch, lambda: fa.flash_attention_ref(
                q, k, v, start, end, causal=causal, scale=scale), iters=4)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True))
            esize = q.element_size()
            nbytes = (q.numel() * 2 + k.numel() * 2) * esize + lse.numel() * 4
            bms, by = bound(nbytes, 4.0 * d * pairs, dt)
            e = entry("flash_attention_fwd")
            e["max_abs_err"] = max(e["max_abs_err"], err)
            e["shapes"].append(dict(shape=label, dtype=dt, ms=ms, plain_ms=plain,
                                    library_ms=lib, bound_ms=bms, bound_by=by, err=err))
            print(f"kernel flash_attention_fwd {label} B{b} S{s} Hq{hq} Hkv{hkv} "
                  f"causal={causal} {dt}: err {err:.3e} ms {ms:.4f} plain {plain:.4f} "
                  f"sdpa {lib:.4f} bound {bms:.4f} ({by})", flush=True)

    norm_cases = [
        ("layer_norm_fwd", 2064, 560), ("layer_norm_fwd", 2064, 512),
        ("layer_norm_fwd", 2064, 25055), ("rms_norm_fwd", 2172, 1536),
        ("rms_norm_fwd", 4, 1536),
    ]
    for name, n, d in norm_cases:
        for dt, dtype in dtypes.items():
            x = (torch.randn(n, d, device=dev, generator=g) * 3 + 1).to(dtype)
            w = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(dtype)
            bb = (0.1 * torch.randn(d, device=dev, generator=g)).to(dtype)
            esize = x.element_size()
            if name == "layer_norm_fwd":
                run = lambda: norms.layer_norm_fwd(x, w, bb)          # noqa: E731
                ref = lambda: norms.layer_norm_ref(x, w, bb)          # noqa: E731
                lib = lambda: F.layer_norm(x, (d,), w, bb, 1e-5)     # noqa: E731
                nbytes, flops = 2 * n * d * esize + 2 * d * esize + 8 * n, 8.0 * n * d
            else:
                run = lambda: norms.rms_norm_fwd(x, w)                # noqa: E731
                ref = lambda: norms.rms_norm_ref(x, w)                # noqa: E731
                lib = lambda: F.rms_norm(x, (d,), w, 1e-6)           # noqa: E731
                nbytes, flops = 2 * n * d * esize + d * esize + 4 * n, 4.0 * n * d
            routes = getattr(getattr(norms, name), "routes", None)
            before = dict(routes or {})
            got = run()
            torch.cuda.synchronize()
            route = rms_route_taken(name, routes, before, n, d, dt)
            err = max(compare(torch, a, r, dt if i == 0 else "f32", f"{name} [{n},{d}] {dt}")
                      for i, (a, r) in enumerate(zip(got, ref())))
            ms, plain, lib_ms = time_ms(torch, run), time_ms(torch, ref), time_ms(torch, lib)
            host_ms, host_lib = eager_ms(torch, run), eager_ms(torch, lib)
            bms, by = bound(nbytes, flops, dt)
            e = entry(name)
            e["max_abs_err"] = max(e["max_abs_err"], err)
            e["shapes"].append(dict(shape=f"{n}x{d}", dtype=dt, ms=ms, plain_ms=plain,
                                    library_ms=lib_ms, bound_ms=bms, bound_by=by, err=err))
            print(f"kernel {name} [{n},{d}] {dt}: err {err:.3e} ms {ms:.4f} plain {plain:.4f} "
                  f"library {lib_ms:.4f} bound {bms:.4f} ({by}); eager call {host_ms:.4f}, "
                  f"library eager {host_lib:.4f}{route}", flush=True)


def phase_kernels_bwd(torch, dev, results):
    """The backward kernels against their plain versions at the training
    shapes.  flash dq and dkv share one plain version (dq, dk, dv at once)
    and one library call (the autograd backward of SDPA), whose times are
    given to both."""
    import torch.nn.functional as F

    from ps_slm_tpu_torch.ops import flash_attention as fa
    from ps_slm_tpu_torch.ops import norms

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    g = torch.Generator(device=dev).manual_seed(1)

    def entry(name):
        return results.setdefault(name, {"max_abs_err": 0.0, "shapes": []})

    def record(name, label, dt, ms, plain, lib, method, nbytes, flops, err):
        bms, by = bound(nbytes, flops, dt)
        e = entry(name)
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["shapes"].append(dict(shape=label, dtype=dt, ms=ms, plain_ms=plain, library_ms=lib,
                                bound_ms=bms, bound_by=by, err=err))
        print(f"kernel {name} {label} {dt}: err {err:.3e} ms {ms:.4f} plain {plain:.4f} "
              f"library {lib:.4f} ({method}) bound {bms:.4f} ({by})", flush=True)

    # flash dq/dkv: the LLM's causal GQA attention at the training shape
    # (every row full, as SDPA's is_causal takes it), and a ragged case
    # with a left-padded row, a right-padded row and a row with no valid key
    flash_cases = [
        ("training", 5, 543, 12, 2, True, [0] * 5, [543] * 5),
        ("ragged", 4, 543, 12, 2, True, [0, 112, 0, 0], [543, 543, 300, 0]),
    ]
    for label, b, s, hq, hkv, causal, starts, ends in flash_cases:
        d = fa.HEAD_DIM
        scale = d ** -0.5
        start = torch.tensor(starts, dtype=torch.int32, device=dev)
        end = torch.tensor(ends, dtype=torch.int32, device=dev)
        pairs = float(fa._pair_mask(start, end, s, s, causal).sum()) * hq
        for dt, dtype in dtypes.items():
            q, do = (torch.randn(b, s, hq, d, device=dev, generator=g).to(dtype) for _ in range(2))
            k, v = (torch.randn(b, s, hkv, d, device=dev, generator=g).to(dtype) for _ in range(2))
            out, lse = fa.flash_attention_fwd(q, k, v, start, end, causal=causal, scale=scale)
            delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
            args = (q, k, v, start, end, out, lse, do, delta)
            kw = dict(causal=causal, scale=scale)
            dq = fa.flash_attention_dq(*args, **kw)
            dk, dv = fa.flash_attention_dkv(*args, **kw)
            torch.cuda.synchronize()
            want = fa.flash_attention_bwd_ref(q, k, v, start, end, out, lse, do, **kw)
            errs = [compare(torch, a, r, dt, f"flash {n} {label} {dt}")
                    for n, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), want)]
            empty = (lse == fa.NEG_INF).transpose(1, 2)
            if label == "ragged" and (not bool(empty.any()) or bool(dq[empty].any())):
                fail(f"flash dq {label} {dt}: a query row with no valid key has a gradient")
            ms_dq = time_ms(torch, lambda: fa.flash_attention_dq(*args, **kw))
            ms_dkv = time_ms(torch, lambda: fa.flash_attention_dkv(*args, **kw))
            plain = time_ms(torch, lambda: fa.flash_attention_bwd_ref(
                q, k, v, start, end, out, lse, do, **kw), iters=4)
            # SDPA takes the ragged windows as a boolean mask (its values on
            # the empty row are NaN: only its time is used)
            mask = None if label == "training" else fa._pair_mask(start, end, s, s, causal)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
            lib, method = backward_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None, scale=scale,
                enable_gqa=True), (qt, kt, vt), do.transpose(1, 2))
            esize = q.element_size()
            stats = 2 * lse.numel() * 4
            record("flash_attention_dq", label, dt, ms_dq, plain, lib, method,
                   (3 * q.numel() + 2 * k.numel()) * esize + stats, 6.0 * d * pairs, errs[0])
            record("flash_attention_dkv", label, dt, ms_dkv, plain, lib, method,
                   (2 * q.numel() + 4 * k.numel()) * esize + stats, 8.0 * d * pairs,
                   max(errs[1:]))
            print(f"flash backward {label} {dt}: dq + dk/dv {ms_dq + ms_dkv:.4f} ms against "
                  f"SDPA's whole backward {lib:.4f} ms ({(ms_dq + ms_dkv) / lib:.2f}x)", flush=True)

    # LayerNorm backward at the projector's norm, RMSNorm backward at the
    # LLM's (5 x 543 merged rows)
    for name, n, d in (("layer_norm_bwd", 2560, 25055), ("rms_norm_bwd", 2715, 1536)):
        for dt, dtype in dtypes.items():
            x = (torch.randn(n, d, device=dev, generator=g) * 3 + 1).to(dtype)
            w = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(dtype)
            bb = (0.1 * torch.randn(d, device=dev, generator=g)).to(dtype)
            gy = torch.randn(n, d, device=dev, generator=g).to(dtype)
            esize = x.element_size()
            xr, wr, br = (t.detach().requires_grad_(True) for t in (x, w, bb))
            if name == "layer_norm_bwd":
                _, mu, rstd = norms.layer_norm_fwd(x, w, bb)
                bwd, bwd_ref, args = norms.layer_norm_bwd, norms.layer_norm_bwd_ref, (x, w, mu, rstd, gy)
                lib, method = backward_ms(
                    torch, lambda: F.layer_norm(xr, (d,), wr, br, 1e-5), (xr, wr, br), gy)
                nbytes = 3 * n * d * esize + 3 * d * esize + 8 * n
                flops = 13.0 * n * d
            else:
                _, rstd = norms.rms_norm_fwd(x, w)
                bwd, bwd_ref, args = norms.rms_norm_bwd, norms.rms_norm_bwd_ref, (x, w, rstd, gy)
                lib, method = backward_ms(
                    torch, lambda: F.rms_norm(xr, (d,), wr, 1e-6), (xr, wr), gy)
                nbytes = 3 * n * d * esize + 2 * d * esize + 4 * n
                flops = 9.0 * n * d
            routes = getattr(bwd, "routes", None)
            before = dict(routes or {})
            got = bwd(*args)
            torch.cuda.synchronize()
            route = rms_route_taken(name, routes, before, n, d, dt)
            want = bwd_ref(*args)
            err = max(compare(torch, a, r, dt, f"{name} [{n},{d}] {dt}", 1.0 if i == 0 else n ** 0.5)
                      for i, (a, r) in enumerate(zip(got, want)))
            ms, plain = time_ms(torch, lambda: bwd(*args)), time_ms(torch, lambda: bwd_ref(*args))
            record(name, f"{n}x{d}", dt, ms, plain, lib, method, nbytes, flops, err)
            kernel_ms = time_ms(torch, lambda: bwd(*args, weight_grad=False))
            if name == "layer_norm_bwd":
                print(f"kernel {name} {n}x{d} {dt}: {kernel_ms:.4f} ms without the partials' sum",
                      flush=True)
                continue
            # frozen weights, the training main path's call: dx alone,
            # against F.rms_norm's backward with the weight not requiring
            # grad
            dx = bwd(*args, weight_grad=False)[0]
            torch.cuda.synchronize()
            err = compare(torch, dx, want[0], dt, f"{name} [{n},{d}] {dt} frozen w")
            lib, method = backward_ms(torch, lambda: F.rms_norm(xr, (d,), w, 1e-6), (xr,), gy)
            record(name, f"{n}x{d} frozen w", dt, kernel_ms, plain, lib, method,
                   nbytes - d * esize, flops - 2.0 * n * d, err)
            print(f"kernel {name} {n}x{d} {dt}{route}", flush=True)


def phase_path_fp32(torch, dev):
    from ps_slm_tpu_torch.config import SENSEVOICE_SMALL, half_audio_configs
    from ps_slm_tpu_torch.inference.generate import _prefill, generate
    from ps_slm_tpu_torch.models.tasu import model_factory, prepare_merged

    tc, mc = half_audio_configs(
        dict(num_blocks=2, tp_blocks=1), dict(num_hidden_layers=2), seed=0
    )
    t0 = time.time()
    cpu_model = model_factory(tc, mc, device="cpu")
    cpu_model.speech_token_id = SPEECH_TOKEN
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    # the main path's lengths: multi-tile flash calls, skipped and fully
    # masked tiles, left-padded rows
    batch = serving_batch(torch, SENSEVOICE_SMALL["input_size"], seed=1)

    outs = {}
    for name, model, d in (("cpu", cpu_model, torch.device("cpu")), ("cuda", gpu_model, dev)):
        bd = {k: v.to(d) for k, v in batch.items()}
        with torch.inference_mode():
            merged = prepare_merged(model, bd, left_padding=True)
            logits, _, _ = _prefill(
                model.llm, merged.embeds, merged.attention_mask, merged.position_ids,
                merged.embeds.shape[1] + 8,
            )
        tokens = generate(model, bd, eos_token_id=EOS, num_beams=1, max_new_tokens=8, device=d)
        outs[name] = (merged, logits.cpu(), tokens.cpu())
    (m_c, l_c, t_c), (m_g, l_g, t_g) = outs["cpu"], outs["cuda"]
    if not (torch.equal(m_c.attention_mask, m_g.attention_mask.cpu())
            and torch.equal(m_c.position_ids, m_g.position_ids.cpu())):
        fail("fp32 path: merged mask or positions differ between card and CPU")
    emb_err = float((m_c.embeds - m_g.embeds.cpu()).abs().max())
    logit_err = float((l_c - l_g).abs().max())
    print(f"path fp32 (2+1 encoder blocks, 2 LLM layers, full width): embeds err "
          f"{emb_err:.3e} prefill logits err {logit_err:.3e} (tol {PATH_TOL}); "
          f"tokens card {t_g.tolist()} cpu {t_c.tolist()} ({time.time() - t0:.1f} s)",
          flush=True)
    if not (emb_err <= PATH_TOL and logit_err <= PATH_TOL):
        fail("fp32 path: card and CPU disagree beyond the tolerance")
    if not torch.isfinite(l_g).all() or not torch.equal(t_c, t_g):
        fail("fp32 path: greedy tokens differ between card and CPU")


def phase_train_fp32(torch, dev):
    """Two training steps of the half_audio recipe at full width and
    reduced depth, fp32, on the card and on the CPU from the same weights."""
    from ps_slm_tpu_torch.config import SENSEVOICE_SMALL, half_audio_configs
    from ps_slm_tpu_torch.models.tasu import model_factory
    from ps_slm_tpu_torch.training.step import make_train_step

    tc, mc = half_audio_configs(
        dict(num_blocks=2, tp_blocks=1), dict(num_hidden_layers=2), seed=0
    )
    tc.lr, tc.warmup_steps = 1e-3, 1
    t0 = time.time()
    cpu_model = model_factory(tc, mc, device="cpu")
    cpu_model.speech_token_id = SPEECH_TOKEN
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    batch = train_batch(torch, SENSEVOICE_SMALL["input_size"], TRAIN_RAGGED_FRAMES, seed=3)

    runs = {}
    for name, model, d in (("cpu", cpu_model, "cpu"), ("cuda", gpu_model, dev)):
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        step = make_train_step(model, tc, device=d)
        metrics = []
        for _ in range(2):
            m = step(batch)
            metrics.append({k: float(v) for k, v in m.items()})
        params = dict(model.named_parameters())
        frozen_same = all(torch.equal(params[n], p) for n, p in start.items()
                          if n not in step.trainable)
        moved = any(not torch.equal(params[n], start[n]) for n in step.trainable)
        if not (frozen_same and moved and len(step.optimizer.state) == 6):
            fail(f"fp32 training on {name}: frozen weights changed ({not frozen_same}), "
                 f"projector did not move ({not moved}), or optimizer state for "
                 f"{len(step.optimizer.state)} tensors, not the projector's 6")
        runs[name] = (metrics, {n: params[n].detach().cpu() for n in step.trainable})
    (m_c, p_c), (m_g, p_g) = runs["cpu"], runs["cuda"]
    errs = {k: max(abs(a[k] - b[k]) for a, b in zip(m_c, m_g)) for k in ("loss", "acc", "ntokens")}
    w_err = max(float((p_c[n] - p_g[n]).abs().max()) for n in p_c)
    print(f"train fp32 (2+1 encoder blocks, 2 LLM layers, full width, frames "
          f"{list(TRAIN_RAGGED_FRAMES)}): losses card {[m['loss'] for m in m_g]} cpu "
          f"{[m['loss'] for m in m_c]}; acc card {[m['acc'] for m in m_g]}; ntokens "
          f"{[m['ntokens'] for m in m_g]}; max err loss {errs['loss']:.3e} acc "
          f"{errs['acc']:.3e} ntokens {errs['ntokens']:.0f}, projector after step 2 "
          f"{w_err:.3e} (tol {PATH_TOL}); frozen weights bit-identical, projector moved "
          f"({time.time() - t0:.1f} s)", flush=True)
    if errs["ntokens"] != 0 or max(errs["loss"], errs["acc"], w_err) > PATH_TOL:
        fail("fp32 training: card and CPU disagree beyond the tolerance")
    if m_g[0]["loss"] != m_g[1]["loss"]:
        fail("fp32 training: the first update (lr 0) changed the loss")


def phase_train_main(torch, dev, model, launches):
    """bench.py's training step at full width, bf16, on ``model`` (the
    serving phase's): TRAIN_WARMUP steps, then TRAIN_STEPS timed ones with
    every kernel's launches counted around them, then one profiled step."""
    import statistics

    from ps_slm_tpu_torch.config import (
        BENCH_BATCH, BENCH_FRAMES, BENCH_TEXT_LEN, SENSEVOICE_SMALL, half_audio_configs,
    )
    from ps_slm_tpu_torch.training.step import make_train_step
    from ps_slm_tpu_torch.utils.flops import H100_BF16_PEAK_FLOPS, tasu_step_flops

    counters = kernel_counters()
    tc, mc = half_audio_configs()          # bench.py: lr 5e-5, warmup 200, 15000 steps
    frames = (BENCH_FRAMES,) * BENCH_BATCH
    batch = train_batch(torch, SENSEVOICE_SMALL["input_size"], frames, seed=0)
    batch["input_features"] = batch["input_features"].to(torch.bfloat16)
    if TEXT_LEN != BENCH_TEXT_LEN:
        fail("training path: the batch is not bench.py's")
    step = make_train_step(model, tc)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if n not in step.trainable}
    t0 = time.perf_counter()
    for _ in range(TRAIN_WARMUP):
        m = step(batch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_counters(counters)
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(m["loss"]))
    for name, fn in counters.items():
        launches[name] = fn.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for name, per_step in LAUNCHES_PER_TRAIN_STEP.items():
        if launches[name] != per_step * TRAIN_STEPS:
            fail(f"training path: {name} launched {launches[name]} times in {TRAIN_STEPS} "
                 f"steps, expected {per_step} per step")
    check_routes(counters, launches, "training path")
    if not all(math.isfinite(x) for x in losses):
        fail(f"training path: non-finite loss {losses}")
    params = dict(model.named_parameters())
    if not all(torch.equal(params[n], p) for n, p in frozen.items()):
        fail("training path: a frozen weight changed")
    del frozen

    fl = tasu_step_flops(model.llm_cfg, model.enc_cfg, mc, batch=BENCH_BATCH,
                         frames=BENCH_FRAMES, text_len=BENCH_TEXT_LEN,
                         freeze_llm=tc.freeze_llm, freeze_encoder=tc.freeze_encoder)
    med = statistics.median(times)
    audio_s = sum(frames) * LFR_FRAME_SEC
    print(f"train main path (bf16, full width, {BENCH_BATCH} x {BENCH_FRAMES} frames, "
          f"{TEXT_LEN} text tokens, merged length {TEXT_LEN + BENCH_FRAMES - 1}): "
          f"{TRAIN_WARMUP} warm-up steps {warm_s:.1f} s; {TRAIN_STEPS} steps median "
          f"{med:.2f} ms (min {min(times):.2f}, max {max(times):.2f}; all "
          f"{[round(t, 2) for t in times]}); {audio_s / med * 1e3:.1f} audio-sec/s; "
          f"{fl['total'] / 1e12:.3f} TFLOP/step, MFU {fl['total'] / (med / 1e3) / H100_BF16_PEAK_FLOPS:.4f} "
          f"(bf16 dense peak {H100_BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s); losses {losses}; "
          f"peak memory {peak_gb:.2f} GB; launches per step "
          f"{ {k: v // TRAIN_STEPS for k, v in launches.items()} }", flush=True)

    wall, busy, ops, top = profiled(torch, lambda: step(batch))
    share = "not measured" if busy is None else f"{busy / wall:.3f}"
    busy_s = "not measured" if busy is None else f"{busy:.2f} ms"
    print(f"profiled train step: wall {wall:.1f} ms, device-busy {busy_s}, busy share "
          f"{share}, {ops} device ops; largest {json.dumps(top)}", flush=True)


def reset_counters(counters) -> None:
    """Every wrapper's launch count, and the RMSNorm wrappers' per-route
    counts, to 0."""
    for fn in counters.values():
        fn.launches = 0
        for route in getattr(fn, "routes", {}):
            fn.routes[route] = 0


def check_routes(counters, launches, what: str) -> None:
    """Fails unless every RMSNorm launch counted since the reset took the
    vectorised route (the main paths are bf16, 1536 wide)."""
    routes = {name: dict(counters[name].routes) for name in RMS_MAIN_SHAPES}
    print(f"{what}: RMSNorm routes {routes}", flush=True)
    for name, r in routes.items():
        if r["vec"] != launches[name] or r["general"]:
            fail(f"{what}: {name} launched {launches[name]} times, {r['vec']} on the "
                 f"vectorised route")


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by name: each carries ``.launches``."""
    from ps_slm_tpu_torch.ops import flash_attention as fa
    from ps_slm_tpu_torch.ops import norms

    return {
        "flash_attention_fwd": fa.flash_attention_fwd,
        "flash_attention_dq": fa.flash_attention_dq,
        "flash_attention_dkv": fa.flash_attention_dkv,
        "layer_norm_fwd": norms.layer_norm_fwd,
        "layer_norm_bwd": norms.layer_norm_bwd,
        "rms_norm_fwd": norms.rms_norm_fwd,
        "rms_norm_bwd": norms.rms_norm_bwd,
    }


def phase_main(torch, dev, launches):
    from ps_slm_tpu_torch.config import QWEN25_1_5B, SENSEVOICE_SMALL, half_audio_configs
    from ps_slm_tpu_torch.inference.generate import _prefill, generate
    from ps_slm_tpu_torch.models.tasu import model_factory, prepare_merged

    counters = kernel_counters()
    tc, mc = half_audio_configs()
    t0 = time.time()
    model = model_factory(tc, mc, dtype=torch.bfloat16)   # default device: cuda
    model.speech_token_id = SPEECH_TOKEN
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"main path: {n_params / 1e9:.3f} B parameters, bf16, init {time.time() - t0:.1f} s",
          flush=True)
    batch = serving_batch(torch, SENSEVOICE_SMALL["input_size"])
    batch["input_features"] = batch["input_features"].to(torch.bfloat16)

    def run(max_new):
        return generate(model, batch, eos_token_id=EOS, num_beams=1, max_new_tokens=max_new)

    run(2)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(counters)
    with counting_steps() as step_starts:
        t0 = time.perf_counter()
        tokens = run(MAX_NEW)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    for name, fn in counters.items():
        launches[name] = fn.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    steps = len(step_starts)
    if tokens.shape != (len(FRAMES), MAX_NEW) or not bool(
            ((tokens >= 0) & (tokens < QWEN25_1_5B["vocab_size"])).all()):
        fail(f"main path: bad tokens {tuple(tokens.shape)}")
    tokens = tokens.cpu()
    if steps != loop_steps(tokens, MAX_NEW):
        fail(f"main path: {steps} decode steps, the tokens need {loop_steps(tokens, MAX_NEW)}")
    need = {name: 0 for name in counters}
    need.update({"flash_attention_fwd": FLASH_PER_GENERATE, "layer_norm_fwd": LN_PER_GENERATE,
                 "rms_norm_fwd": RMS_PER_FORWARD * (1 + steps)})
    for name, n in need.items():
        if launches[name] != n:
            fail(f"main path: {name} launched {launches[name]} times, expected {n}")
    check_routes(counters, launches, "main path")

    total_ms = (t_end - t0) * 1e3
    first_ms = (step_starts[0] - t0) * 1e3 if steps else total_ms
    step_ms = (t_end - step_starts[0]) * 1e3 / steps if steps else 0.0
    audio_s = sum(FRAMES) * LFR_FRAME_SEC
    n_tok = real_tokens(tokens, steps)
    print(f"main path: generate {total_ms:.1f} ms = first token {first_ms:.1f} ms "
          f"(front half + LLM prefill) + {steps} decode steps x {step_ms:.2f} ms; "
          f"{audio_s / total_ms * 1e3:.1f} audio-sec/s, {n_tok} tokens generated, "
          f"{n_tok / total_ms * 1e3:.1f} tokens/s; peak memory {peak_gb:.2f} GB; "
          f"launches {launches}", flush=True)

    # the first token's split, from a second, separately timed run
    bd = {k: v.to(dev) for k, v in batch.items()}
    with torch.inference_mode():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        merged = prepare_merged(model, bd, left_padding=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        logits, _, _ = _prefill(model.llm, merged.embeds, merged.attention_mask,
                                merged.position_ids, merged.embeds.shape[1] + MAX_NEW)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    if not bool(torch.isfinite(logits).all()) or not bool(torch.isfinite(merged.embeds.float()).all()):
        fail("main path: non-finite merged embeddings or prefill logits")
    print(f"main path, split run: merged length {merged.embeds.shape[1]}, valid merged "
          f"lengths {merged.attention_mask.sum(1).tolist()}; front half "
          f"{(t2 - t1) * 1e3:.1f} ms, LLM prefill {(t3 - t2) * 1e3:.1f} ms", flush=True)

    # device-busy share: generate with no decode step, then the whole
    # call, each under the profiler with its own wall time
    with counting_steps() as prof_steps:
        first = profiled(torch, lambda: run(1))
        whole = profiled(torch, lambda: run(MAX_NEW))
    for label, (wall, busy, ops, top) in (("first token", first), ("whole generate", whole)):
        share = "not measured" if busy is None else f"{busy / wall:.3f}"
        busy_s = "not measured" if busy is None else f"{busy:.2f} ms"
        print(f"profiled {label}: wall {wall:.1f} ms, device-busy {busy_s}, busy share "
              f"{share}, {ops} device ops; largest {json.dumps(top)}", flush=True)
    n = len(prof_steps)
    if n and first[1] is not None and whole[1] is not None:
        d_wall, d_busy = whole[0] - first[0], whole[1] - first[1]
        print(f"profiled decode ({n} steps, whole - first token): {d_wall / n:.2f} ms wall, "
              f"{d_busy / n:.3f} ms device-busy, {(whole[2] - first[2]) / n:.0f} device ops "
              f"per step; busy share {d_busy / d_wall:.3f}", flush=True)
    return model


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(HERE, "ps_slm_tpu_torch", "csrc")):
        fail("the ps_slm_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    from ps_slm_tpu_torch import _build

    t_start = time.time()
    dev = torch.device("cuda", 0)
    try:
        card = card_line()
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        fail(f"nvidia-smi: {e}")
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    try:
        logs = _build.build_all()
    except RuntimeError as e:
        fail(f"build: {e}")
    print(f"build: {time.time() - t0:.1f} s ({', '.join(_build.SOURCES)})", flush=True)
    phase_paths(logs)

    print("kernel vs plain tolerance, |a - b| <= atol + rtol * |b|: "
          + ", ".join(f"{dt} atol {a} rtol {r}" for dt, (a, r) in KERNEL_TOL.items()),
          flush=True)
    results: dict = {}
    phase_kernels(torch, dev, results)
    phase_kernels_bwd(torch, dev, results)
    phase_path_fp32(torch, dev)
    phase_train_fp32(torch, dev)
    gen_launches: dict = {}
    model = phase_main(torch, dev, gen_launches)
    train_launches: dict = {}
    phase_train_main(torch, dev, model, train_launches)

    # name: (source, TPU kernel it replaces, the row of phase 3 reported)
    sources = {
        "flash_attention_fwd": ("ps_slm_tpu_torch/csrc/flash_fwd.cu",
                                "ps_slm_tpu/ops/flash_attention.py:59", "encoder"),
        "flash_attention_dq": ("ps_slm_tpu_torch/csrc/flash_bwd.cu",
                               "ps_slm_tpu/ops/flash_attention.py:125", "training"),
        "flash_attention_dkv": ("ps_slm_tpu_torch/csrc/flash_bwd.cu",
                                "ps_slm_tpu/ops/flash_attention.py:181", "training"),
        "layer_norm_fwd": ("ps_slm_tpu_torch/csrc/norms.cu", "ps_slm_tpu/ops/norms.py:49",
                           "2064x512"),
        "layer_norm_bwd": ("ps_slm_tpu_torch/csrc/norms.cu", "ps_slm_tpu/ops/norms.py:73",
                           "2560x25055"),
        "rms_norm_fwd": ("ps_slm_tpu_torch/csrc/norms.cu", "ps_slm_tpu/ops/norms.py:61",
                         "2172x1536"),
        "rms_norm_bwd": ("ps_slm_tpu_torch/csrc/norms.cu", "ps_slm_tpu/ops/norms.py:94",
                         "2715x1536 frozen w"),
    }
    kernels = []
    for name, (source, replaces, shape) in sources.items():
        row = next(r for r in results[name]["shapes"] if r["shape"] == shape and r["dtype"] == "bf16")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": gen_launches[name] + train_launches[name],
            "launches_per_generate": gen_launches[name],
            "launches_per_train_step": train_launches[name] // TRAIN_STEPS,
            "max_abs_err": results[name]["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": f"{shape} bf16",
        })
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
