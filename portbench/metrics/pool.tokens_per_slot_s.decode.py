"""Served tokens of the window's completed requests over the sum of their
seconds in a slot: from when the pool pulled the request from the
harness's source to when ``run()`` yielded it (host clock)."""

UNIT, LAYER, MOVES = "tokens/s", "serving pool", "decode_audio_s_per_s"


def read(run):
    busy = run.facts.get("in_slot_s")
    return None if not busy else run.facts["tokens"] / busy
