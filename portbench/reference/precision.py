"""The precision of the reference's products.

``float32`` by default.  The controls of the training cells (``--control
fp8``) compute the reference one step below the configuration's bf16:
every matrix product's inputs rounded to float8 e4m3 with a per-tensor
scale (largest magnitude to 448), the product and all else in float32;
gradients pass the rounding unchanged.
"""

import contextlib

import torch

_MODE = {"fp8": False}


def q8(x: torch.Tensor) -> torch.Tensor:
    if not _MODE["fp8"] or x.numel() == 0:
        return x
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    y = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (y - x.detach())


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the reference's precision."""
    return q8(a) @ q8(b)


@contextlib.contextmanager
def fp8():
    _MODE["fp8"] = True
    try:
        yield
    finally:
        _MODE["fp8"] = False
