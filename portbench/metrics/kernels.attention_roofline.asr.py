"""The flash forward's share of its roofline in the traced window's ASR
passes: every encoder layer's non-causal attention over each utterance's
valid positions (``counting.attention``), least time summed, over the
device time of the kernels named below."""

import re

from portbench import counting

UNIT, LAYER, MOVES = "%", "kernels", "asr_audio_s_per_s"
KERNELS = re.compile(r"(?<![A-Za-z0-9_])flash_fwd")


def read(run):
    t, lengths = run.trace_summary, run.facts.get("asr_lengths")
    if t is None or not lengths:
        return None
    seconds = t.kernel_seconds(lambda n: KERNELS.search(n) is not None)
    if seconds <= 0:
        return None
    e = run.cfg["encoder"]
    heads, layers = e["attention_heads"], e["num_blocks"] + e["tp_blocks"]
    least = sum(layers * counting.least_seconds(*counting.attention(
        n, heads, heads, e["output_size"] // heads, causal=False)) for n in lengths)
    return 100.0 * least / seconds
