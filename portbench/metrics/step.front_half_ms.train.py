"""Host milliseconds a training step spent in the front half (the
program's ``tasu.front_half`` spans inside ``tasu.step``: the front end,
encoder, posterior, PSD, projector and merge, as enqueued) over the
``tasu.step`` spans of the traced window."""

from portbench import program_spans as ps

UNIT, LAYER, MOVES = "ms", "training step", "train_tokens_per_s"


def read(run):
    rec = ps.recorded()
    s, n = ps.seconds(rec, "step/front_half"), ps.calls(rec, "step")
    return None if s is None or not n else 1000.0 * s / n
