"""Share of the traced window in which no operation ran on the card: the
window less the union of the device's operation intervals, over the
window."""

UNIT, LAYER, MOVES = "%", "device", "asr_audio_s_per_s"


def read(run):
    t = run.trace_summary
    return None if t is None or t.window_s <= 0 else 100.0 * (1 - t.busy_s / t.window_s)
