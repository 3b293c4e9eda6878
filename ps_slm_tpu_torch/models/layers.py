"""Shared layers and init helpers.

Counterpart of ``ps_slm_tpu/models/layers.py``.  Linear layers are
``nn.Linear``: weights stored [out, in] and applied as ``x @ W.T``.  The JAX
package stores kernels [in, out]; :mod:`ps_slm_tpu_torch.convert` transposes
them once.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ps_slm_tpu_torch.ops.norms import LayerNormFn


def run_block(layer: nn.Module, remat: bool, *args) -> torch.Tensor:
    """``layer(*args)``; with ``remat``, under ``torch.utils.checkpoint``:
    nothing inside is saved for the backward, which runs the block again
    (the JAX ``jax.checkpoint`` of the block body).  The blocks draw no
    random numbers, so no RNG state is kept."""
    if remat:
        return checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=False)
    return layer(*args)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm with fp32 statistics, output in x.dtype (the reference's
    fp32-LayerNorm policy); the CUDA kernels, forward and backward, on CUDA
    tensors."""
    return LayerNormFn.apply(x, weight, bias, eps)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()


@torch.no_grad()
def uniform_(p: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    """Fill ``p`` from U(-bound, bound), drawn in fp32 on p's device."""
    r = torch.rand(p.shape, generator=generator, device=p.device, dtype=torch.float32)
    p.copy_(r * (2 * bound) - bound)


@torch.no_grad()
def normal_(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill ``p`` from N(0, std^2), drawn in fp32 on p's device."""
    r = torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32)
    p.copy_(r * std)


def linear_init_(linear: nn.Linear, generator: torch.Generator) -> None:
    """torch.nn.Linear's default init (kaiming-uniform weight, uniform bias),
    as ``layers.linear_init`` of the JAX package."""
    bound = 1.0 / math.sqrt(linear.in_features)
    uniform_(linear.weight, bound, generator)
    if linear.bias is not None:
        uniform_(linear.bias, bound, generator)
