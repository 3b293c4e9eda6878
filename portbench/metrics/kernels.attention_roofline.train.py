"""The flash kernels' share of their roofline in the traced window's
training steps: the least time of every attention call the steps' shapes
need (the encoder's forward, the LLM's forward and backward, at the rows'
valid positions; ``counting.attention``), max(FLOPs / 989 T, bytes /
3.35 T) summed, over the device time of the kernels named below."""

import re

from portbench import counting

UNIT, LAYER, MOVES = "%", "kernels", "train_tokens_per_s"
KERNELS = re.compile(r"(?<![A-Za-z0-9_])(flash_(fwd|dq|dkv)|dkv_reduce)")


def read(run):
    t, steps = run.trace_summary, run.facts.get("steps")
    if t is None or not steps:
        return None
    seconds = t.kernel_seconds(lambda n: KERNELS.search(n) is not None)
    if seconds <= 0:
        return None
    enc = run.facts.get("encoder", True)
    work = [counting.train_step(run.cfg, s["rows"], enc)["attention"] for s in steps]
    least = sum(counting.least_seconds(f, b) for f, b in work)
    return 100.0 * least / seconds
