"""Requests a front-half call of the slot pool's refills
(``pool.front_half_rows`` / ``pool.front_half_calls``), in the traced
window; nothing from a program that has no such counters."""

from portbench import program_spans as ps

UNIT, LAYER, MOVES = "rows", "serving pool", "decode_audio_s_per_s"
CALLS, ROWS = "pool.front_half_calls", "pool.front_half_rows"


def _counts_calls() -> bool:
    try:
        from ps_slm_tpu_torch.utils import profiler
    except ImportError:
        return False
    return CALLS in getattr(profiler, "COUNTERS", ())


def read(run):
    rec = ps.recorded()
    calls = ps.counted(rec, CALLS)
    if not calls or not _counts_calls():
        return None
    return ps.counted(rec, ROWS) / calls
