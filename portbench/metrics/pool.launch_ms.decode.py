"""Host milliseconds the slot pool took to enqueue a chunk of
``sync_every`` steps over every slot (the program's ``tasu.pool.launch``
spans) over the chunks launched (``pool.chunks``), in the traced
window."""

from portbench import program_spans as ps

UNIT, LAYER, MOVES = "ms", "serving pool", "decode_audio_s_per_s"


def read(run):
    rec = ps.recorded()
    s, n = ps.seconds(rec, "pool.launch"), ps.counted(rec, "pool.chunks")
    return None if s is None or not n else 1000.0 * s / n
