"""The norm kernels' share of their roofline in the traced window's
training steps: every LayerNorm and RMSNorm call of the steps, forward and
backward, at the rows' valid positions (``counting.norm``), its least time
summed, over the device time of the kernels named below."""

import re

from portbench import counting

UNIT, LAYER, MOVES = "%", "kernels", "train_tokens_per_s"
KERNELS = re.compile(r"(?<![A-Za-z0-9_])(layer_norm_(fwd|bwd)|rms_norm_(fwd|bwd)|norm_fwd_vec"
                     r"|partial_sum_kernel)")


def read(run):
    t, steps = run.trace_summary, run.facts.get("steps")
    if t is None or not steps:
        return None
    seconds = t.kernel_seconds(lambda n: KERNELS.search(n) is not None)
    if seconds <= 0:
        return None
    enc = run.facts.get("encoder", True)
    work = [counting.train_step(run.cfg, s["rows"], enc)["norm"] for s in steps]
    least = sum(counting.least_seconds(f, b) for f, b in work)
    return 100.0 * least / seconds
