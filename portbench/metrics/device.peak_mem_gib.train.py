"""The card's peak allocated memory over set-up and window
(``torch.cuda.max_memory_allocated``), GiB."""

UNIT, LAYER, MOVES = "GiB", "device", "train_tokens_per_s"


def read(run):
    return run.mem_peak / 2 ** 30 if run.mem_peak else None
