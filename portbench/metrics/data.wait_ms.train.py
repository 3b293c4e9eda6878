"""Milliseconds the training step waited on ``device_prefetch``'s
``next()`` (reading, decoding and collating audio, the copy to the card),
summed over the traced window's steps."""

UNIT, LAYER, MOVES = "ms", "data", "train_tokens_per_s"


def read(run):
    wait = run.facts.get("data_wait_s")
    return None if wait is None else 1000.0 * wait
