"""Useful model FLOPs of the traced window's training steps over the
window times the H100's dense bf16 peak (989 TFLOP/s): ``counting.train_step``
at the rows' valid positions, the audio span at the frames the
reference's PSD keeps, causal scores halved, frozen parts' multipliers."""

from portbench import counting

UNIT, LAYER, MOVES = "%", "training step", "train_tokens_per_s"


def read(run):
    steps, window = run.facts.get("steps"), run.facts.get("window_s")
    if not steps or not window:
        return None
    enc = run.facts.get("encoder", True)
    flops = sum(counting.train_step(run.cfg, s["rows"], enc)["model"][0] for s in steps)
    return 100.0 * flops / (window * counting.PEAK_FLOPS)
