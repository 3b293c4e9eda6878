"""Share of the slot pool's chunks launched as a replay of its CUDA graph
(``pool.graph_replays``) among the chunks launched (``pool.chunks``), in
the traced window; nothing from a program that has no such counter."""

from portbench import program_spans as ps

UNIT, LAYER, MOVES = "%", "serving pool", "decode_audio_s_per_s"
REPLAYS = "pool.graph_replays"


def _counts_replays() -> bool:
    try:
        from ps_slm_tpu_torch.utils import profiler
    except ImportError:
        return False
    return REPLAYS in getattr(profiler, "COUNTERS", ())


def read(run):
    rec = ps.recorded()
    chunks = ps.counted(rec, "pool.chunks")
    if not chunks or not _counts_replays():
        return None
    return 100.0 * ps.counted(rec, REPLAYS) / chunks
