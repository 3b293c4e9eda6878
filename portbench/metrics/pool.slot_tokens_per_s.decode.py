"""Tokens the slot pool kept for the requests it finished in the traced
window (``pool.tokens``) over their seconds in a slot by the pool's own
clock (``pool.slot_s``: from each request's install to its finish): the
program's twin of ``pool.tokens_per_slot_s.decode``, whose seconds start
at the pull, before the admission and the refill."""

from portbench import program_spans as ps

UNIT, LAYER, MOVES = "tokens/s", "serving pool", "decode_audio_s_per_s"


def read(run):
    rec = ps.recorded()
    busy = ps.counted(rec, "pool.slot_s")
    return None if not busy else ps.counted(rec, "pool.tokens") / busy
