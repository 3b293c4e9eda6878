"""LayerNorm and RMSNorm forward: CUDA kernels and their plain versions.

Counterpart of ``ps_slm_tpu/ops/norms.py`` (forward only; the backward
kernels come with the training slice).  Statistics are fp32; x, the
weights and y are bf16 or fp32.

``layer_norm_fwd`` and ``rms_norm_fwd`` launch the kernels of
``csrc/norms.cu`` for CUDA tensors and take the plain versions
``layer_norm_ref`` / ``rms_norm_ref`` only for CPU tensors.  There is no
width gate: every CUDA call goes through the kernel, at any d.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ps_slm_tpu_torch import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # device, dtype, x, w, b, y, mu, rstd, n, d, eps, stream
    "ps_layer_norm_fwd": (_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P),
    # device, dtype, x, w, y, rstd, n, d, eps, stream
    "ps_rms_norm_fwd": (_I, _I, _P, _P, _P, _P, _I, _I, _F, _P),
}


def layer_norm_ref(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain LayerNorm (``_ln_fwd_kernel`` math): returns y in x.dtype and
    fp32 ``mu``, ``rstd`` of shape ``x.shape[:-1] + (1,)``."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    xc = x32 - mu
    var = (xc * xc).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd * weight.float() + bias.float()
    return y.to(x.dtype), mu, rstd


def rms_norm_ref(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain RMSNorm (``_rms_fwd_kernel`` math): returns y in x.dtype and
    fp32 ``rstd`` of shape ``x.shape[:-1] + (1,)``."""
    x32 = x.float()
    rstd = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * rstd * weight.float()).to(x.dtype), rstd


def _check_cuda(x: torch.Tensor, params, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, got {x.device}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() < 1 or x.shape[-1] == 0 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous with a non-empty last dim")
    for p in params:
        if p.device != x.device or p.dtype != x.dtype:
            raise TypeError(f"{name}: weights must match x in device and dtype")
        if p.shape != (x.shape[-1],) or not p.is_contiguous():
            raise ValueError(f"{name}: weights must be contiguous [{x.shape[-1]}]")


def layer_norm_fwd(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LayerNorm over the last dim: ``(y, mu, rstd)`` as :func:`layer_norm_ref`."""
    if x.device.type == "cpu":
        return layer_norm_ref(x, weight, bias, eps)
    _check_cuda(x, (weight, bias), "layer_norm_fwd")
    d = x.shape[-1]
    n = x.numel() // d
    y = torch.empty_like(x)
    mu = torch.empty(x.shape[:-1] + (1,), device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mu)
    if n == 0:
        return y, mu, rstd
    lib = _build.load("norms", _SIGNATURES)
    err = lib.ps_layer_norm_fwd(
        x.device.index, _build.DTYPE_CODES[x.dtype], x.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), y.data_ptr(), mu.data_ptr(),
        rstd.data_ptr(), n, d, eps, _build.stream_ptr(x),
    )
    _build.check(lib, err, "layer_norm_fwd")
    layer_norm_fwd.launches += 1
    return y, mu, rstd


layer_norm_fwd.launches = 0


def rms_norm_fwd(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMSNorm over the last dim: ``(y, rstd)`` as :func:`rms_norm_ref`."""
    if x.device.type == "cpu":
        return rms_norm_ref(x, weight, eps)
    _check_cuda(x, (weight,), "rms_norm_fwd")
    d = x.shape[-1]
    n = x.numel() // d
    y = torch.empty_like(x)
    rstd = torch.empty(x.shape[:-1] + (1,), device=x.device, dtype=torch.float32)
    if n == 0:
        return y, rstd
    lib = _build.load("norms", _SIGNATURES)
    err = lib.ps_rms_norm_fwd(
        x.device.index, _build.DTYPE_CODES[x.dtype], x.data_ptr(),
        weight.data_ptr(), y.data_ptr(), rstd.data_ptr(), n, d, eps,
        _build.stream_ptr(x),
    )
    _build.check(lib, err, "rms_norm_fwd")
    rms_norm_fwd.launches += 1
    return y, rstd


rms_norm_fwd.launches = 0
