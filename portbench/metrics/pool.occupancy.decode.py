"""Tokens the slot pool kept for its finished requests (``pool.tokens``:
to each one's EOS or cap) over the slot-steps it launched
(``pool.slot_steps``: slots x ``sync_every`` a chunk), in the traced
window: the share of decode steps that served a token."""

from portbench import program_spans as ps

UNIT, LAYER, MOVES = "%", "serving pool", "decode_audio_s_per_s"


def read(run):
    rec = ps.recorded()
    steps = ps.counted(rec, "pool.slot_steps")
    return None if not steps else 100.0 * ps.counted(rec, "pool.tokens") / steps
