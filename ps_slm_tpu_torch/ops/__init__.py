"""Ops of the PyTorch/CUDA port: attention, norms, PSD, merge, CE loss."""


def fp32_reciprocal(x: float) -> float:
    """The fp32 reciprocal of ``x``.  XLA folds a division by a
    compile-time constant (a static penalty, temperature or vocabulary
    size in the JAX package) into a multiply by this value, so the port
    multiplies by it where the JAX code divides by a constant, and rounds
    as the JAX package does."""
    import numpy as np

    return float(np.float32(1) / np.float32(x))

