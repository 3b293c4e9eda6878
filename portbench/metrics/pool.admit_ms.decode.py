"""Host milliseconds the slot pool spent pulling a request from its source
(the program's ``tasu.pool.admit`` spans: the caller's dataset, collator
and copy to the card) over the requests it installed (``pool.requests``),
in the traced window."""

from portbench import program_spans as ps

UNIT, LAYER, MOVES = "ms", "serving pool", "decode_audio_s_per_s"


def read(run):
    rec = ps.recorded()
    s, n = ps.seconds(rec, "pool.admit"), ps.counted(rec, "pool.requests")
    return None if s is None or not n else 1000.0 * s / n
