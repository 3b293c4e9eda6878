"""Milliseconds the training loop's consumer waited on ``device_prefetch``
in the traced window (the program's ``tasu.data.wait`` spans: the queue's
get and the stream's wait on the batch's copy): the program's twin of
``data.wait_ms.train``, the harness's span around each ``next()``."""

from portbench import program_spans as ps

UNIT, LAYER, MOVES = "ms", "data", "train_tokens_per_s"


def read(run):
    s = ps.seconds(ps.recorded(), "data.wait")
    return None if s is None else 1000.0 * s
