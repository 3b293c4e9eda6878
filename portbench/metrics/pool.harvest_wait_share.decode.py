"""Share of the traced window the slot pool's harvest waited on the
device for a chunk's tokens (the program's ``tasu.pool.harvest_wait``
spans, inside ``tasu.pool.harvest``): the more, the more the device paces
the pool."""

from portbench import program_spans as ps

UNIT, LAYER, MOVES = "%", "serving pool", "decode_audio_s_per_s"


def read(run):
    s = ps.seconds(ps.recorded(), "pool.harvest/pool.harvest_wait")
    window = run.facts.get("window_s")
    return None if s is None or not window else 100.0 * s / window
