"""Host milliseconds of the slot pool's refills (the program's
``tasu.pool.refill`` spans: each group's front half, then the B=k prefill
and install) over the requests installed (``pool.requests``), in the
traced window."""

from portbench import program_spans as ps

UNIT, LAYER, MOVES = "ms", "serving pool", "decode_audio_s_per_s"


def read(run):
    rec = ps.recorded()
    s, n = ps.seconds(rec, "pool.refill"), ps.counted(rec, "pool.requests")
    return None if s is None or not n else 1000.0 * s / n
