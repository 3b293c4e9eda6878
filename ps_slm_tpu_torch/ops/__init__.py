"""Ops of the PyTorch/CUDA port: attention, norms, PSD, merge, CE loss."""

from typing import NamedTuple, Optional


def fp32_reciprocal(x: float) -> float:
    """The fp32 reciprocal of ``x``.  XLA folds a division by a
    compile-time constant (a static penalty, temperature or vocabulary
    size in the JAX package) into a multiply by this value, so the port
    multiplies by it where the JAX code divides by a constant, and rounds
    as the JAX package does."""
    import numpy as np

    return float(np.float32(1) / np.float32(x))



class RowBlock(NamedTuple):
    """This process's rows of a global batch split in ``count`` equal
    blocks: block ``index`` (``parallel/mesh.py``)."""

    index: int
    count: int


def draw_rows(draw, shape, block: Optional[RowBlock]):
    """``draw(shape)`` (a function of a shape that draws from a generator)
    for this process's rows: with a ``block``, drawn at the global batch's
    shape (``shape[0] * count`` rows) and cut to the block, so that every
    process draws what one process would for the whole batch."""
    shape = tuple(shape)
    if block is None or block.count == 1:
        return draw(shape)
    b = shape[0]
    return draw((b * block.count,) + shape[1:])[block.index * b:(block.index + 1) * b]
