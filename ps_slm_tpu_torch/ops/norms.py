"""LayerNorm and RMSNorm, forward and backward: CUDA kernels, their plain
versions and the autograd Functions over them.

Counterpart of ``ps_slm_tpu/ops/norms.py``.  Statistics and gradient sums
are fp32; x, the weights, y and dx are bf16 or fp32.

``layer_norm_fwd``, ``rms_norm_fwd``, ``layer_norm_bwd`` and
``rms_norm_bwd`` launch the kernels of ``csrc/norms.cu`` for CUDA tensors
and take the plain versions (``*_ref``) only for CPU tensors.  There is no
width gate: every CUDA call goes through a kernel, at any d.  The RMSNorm
wrappers pick one of two kernel routes with :func:`rms_route` (a warp per
row from 16-byte loads, or a block per row for any width and alignment)
and count their launches per route in ``.routes``.
:class:`LayerNormFn` and :class:`RMSNormFn` put a forward and its backward
together for autograd, saving what the JAX custom VJPs save: ``x, w, mu,
rstd`` for LayerNorm; ``x`` in its own dtype, ``w`` and the fp32 ``rstd``
for RMSNorm (the residual-thin stash of ``rms_norm_ref`` there).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ps_slm_tpu_torch import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # device, dtype, x, w, b, y, mu, rstd, n, d, eps, stream
    "ps_layer_norm_fwd": (_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P),
    # device, dtype, x, w, y, rstd, n, d, eps, stream
    "ps_rms_norm_fwd": (_I, _I, _P, _P, _P, _P, _I, _I, _F, _P),
    # device, dtype, x, w, mu, rstd, g, dx, dw_part, db_part, n, d,
    # n_blocks, stream
    "ps_layer_norm_bwd": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # device, dtype, x, w, rstd, g, dx, dw_part (null: no dw), n, d,
    # n_blocks, stream
    "ps_rms_norm_bwd": (_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # the vectorised route: device, dtype, x, w, y, rstd, n, d, eps,
    # n_blocks, stream
    "ps_rms_norm_fwd_vec": (_I, _I, _P, _P, _P, _P, _I, _I, _F, _I, _P),
    # device, dtype, x, w, rstd, g, dx, dw_part (null: no dw), n, d,
    # n_blocks, stream
    "ps_rms_norm_bwd_vec": (_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # device, dtype, dw_part, dw, n_blocks, d, stream
    "ps_rms_norm_dw_sum": (_I, _I, _P, _P, _I, _I, _P),
}

# The RMSNorm kernels' vectorised route takes rows of at most this many
# bytes (csrc/norms.cu: RMS_MAX_CHUNKS = 7 16-byte chunks a lane, 32 lanes)
VEC_ROW_BYTES = 7 * 32 * 16
# blocks of 4 warps an SM for the vectorised kernels, each block a run of
# consecutive rows: as many as the kernels' registers let an SM hold at
# 1536 wide in bf16 (151 a thread forward, 218-232 backward), the fastest
# of 1, 2, 3, 4, 6 and 8 on the H100
_VEC_FWD_BLOCKS_PER_SM = 3
_VEC_BWD_BLOCKS_PER_SM = 2


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


def layer_norm_bwd_ref(
    x: torch.Tensor, weight: torch.Tensor, mu: torch.Tensor, rstd: torch.Tensor,
    g: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain LayerNorm backward (``_ln_bwd_kernel`` math) from the forward's
    fp32 ``mu``/``rstd``: ``(dx in x.dtype, dw, db in weight.dtype)``."""
    d = x.shape[-1]
    g32 = g.float()
    xhat = (x.float() - mu) * rstd
    gw = g32 * weight.float()
    m1 = gw.mean(-1, keepdim=True)
    m2 = (gw * xhat).mean(-1, keepdim=True)
    dx = (gw - m1 - xhat * m2) * rstd
    dw = (g32 * xhat).reshape(-1, d).sum(0)
    db = g32.reshape(-1, d).sum(0)
    return dx.to(x.dtype), dw.to(weight.dtype), db.to(weight.dtype)


def rms_norm_bwd_ref(
    x: torch.Tensor, weight: torch.Tensor, rstd: torch.Tensor, g: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain RMSNorm backward (``_rms_bwd_kernel`` math) from the forward's
    fp32 ``rstd``: ``(dx in x.dtype, dw in weight.dtype)``."""
    d = x.shape[-1]
    g32 = g.float()
    xhat = x.float() * rstd
    gw = g32 * weight.float()
    m = (gw * xhat).mean(-1, keepdim=True)
    dx = (gw - xhat * m) * rstd
    dw = (g32 * xhat).reshape(-1, d).sum(0)
    return dx.to(x.dtype), dw.to(weight.dtype)


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


def rms_route(d: int, dtype: torch.dtype, ptrs) -> str:
    """The RMSNorm kernel route for rows of ``d`` elements of ``dtype`` at
    the data pointers ``ptrs`` (x, w and y for the forward; x, w, g and dx
    for the backward): ``"vec"``, a warp per row from 16-byte loads, where
    a row is a whole number of 16-byte chunks, at most ``VEC_ROW_BYTES``,
    and every pointer is 16-byte aligned; else ``"general"``.  A contiguous
    tensor at an odd storage offset is not aligned, so it takes the
    general route."""
    row = d * dtype.itemsize
    if row % 16 or row > VEC_ROW_BYTES or any(p % 16 for p in ptrs):
        return "general"
    return "vec"


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
    ptrs = (x.data_ptr(), weight.data_ptr(), y.data_ptr())
    route = rms_route(d, x.dtype, ptrs)
    args = (x.device.index, _build.DTYPE_CODES[x.dtype], *ptrs, rstd.data_ptr(), n, d, eps)
    if route == "vec":
        err = lib.ps_rms_norm_fwd_vec(
            *args, _blocks(x, n, _VEC_FWD_BLOCKS_PER_SM), _build.stream_ptr(x))
    else:
        err = lib.ps_rms_norm_fwd(*args, _build.stream_ptr(x))
    _build.check(lib, err, "rms_norm_fwd")
    rms_norm_fwd.launches += 1
    rms_norm_fwd.routes[route] += 1
    return y, rstd


rms_norm_fwd.launches = 0
rms_norm_fwd.routes = {"vec": 0, "general": 0}


def _check_bwd(x, g, stats, name: str) -> None:
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise TypeError(f"{name}: g must match x in shape, dtype and device")
    if not g.is_contiguous():
        raise ValueError(f"{name}: g must be contiguous")
    for t in stats:
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError(f"{name}: statistics must be fp32 on x's device")
        if t.shape != x.shape[:-1] + (1,) or not t.is_contiguous():
            raise ValueError(f"{name}: statistics must be contiguous {tuple(x.shape[:-1]) + (1,)}")


def _blocks(x: torch.Tensor, n: int, per_sm: int) -> int:
    """Blocks of a launch that gives each block a run of consecutive rows
    (for a backward, the rows of its partial-sum buffers): ``per_sm`` an
    SM, fewer where there are fewer rows."""
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    per = -(-n // (per_sm * sms))
    return -(-n // per)


def layer_norm_bwd(
    x: torch.Tensor, weight: torch.Tensor, mu: torch.Tensor, rstd: torch.Tensor,
    g: torch.Tensor, *, weight_grad: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """LayerNorm backward: ``(dx, dw, db)`` as :func:`layer_norm_bwd_ref`.

    dx is always computed.  The kernel writes dw/db as per-block partial
    sums; ``weight_grad=False`` skips summing them and returns None for
    both (frozen weights)."""
    if x.device.type == "cpu":
        dx, dw, db = layer_norm_bwd_ref(x, weight, mu, rstd, g)
        return (dx, dw, db) if weight_grad else (dx, None, None)
    _check_cuda(x, (weight,), "layer_norm_bwd")
    _check_bwd(x, g, (mu, rstd), "layer_norm_bwd")
    d = x.shape[-1]
    n = x.numel() // d
    dx = torch.empty_like(x)
    if n == 0:
        zeros = torch.zeros_like(weight)
        return (dx, zeros, zeros.clone()) if weight_grad else (dx, None, None)
    nb = _blocks(x, n, per_sm=1)   # each block's partial rows fill its SM's shared memory
    dw_part = torch.empty((nb, d), device=x.device, dtype=torch.float32)
    db_part = torch.empty_like(dw_part)
    lib = _build.load("norms", _SIGNATURES)
    err = lib.ps_layer_norm_bwd(
        x.device.index, _build.DTYPE_CODES[x.dtype], x.data_ptr(),
        weight.data_ptr(), mu.data_ptr(), rstd.data_ptr(), g.data_ptr(),
        dx.data_ptr(), dw_part.data_ptr(), db_part.data_ptr(), n, d, nb,
        _build.stream_ptr(x),
    )
    _build.check(lib, err, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    if not weight_grad:
        return dx, None, None
    return dx, dw_part.sum(0).to(weight.dtype), db_part.sum(0).to(weight.dtype)


layer_norm_bwd.launches = 0


def rms_norm_bwd(
    x: torch.Tensor, weight: torch.Tensor, rstd: torch.Tensor, g: torch.Tensor,
    *, weight_grad: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """RMSNorm backward: ``(dx, dw)`` as :func:`rms_norm_bwd_ref`.

    dx is always computed.  With ``weight_grad=False`` (frozen weights) the
    kernel computes no dw, no partial rows are allocated, and dw is None;
    else the kernel's per-block partial rows are summed by a second kernel
    in a fixed order, so dw is the same bits from call to call."""
    if x.device.type == "cpu":
        dx, dw = rms_norm_bwd_ref(x, weight, rstd, g)
        return (dx, dw) if weight_grad else (dx, None)
    _check_cuda(x, (weight,), "rms_norm_bwd")
    _check_bwd(x, g, (rstd,), "rms_norm_bwd")
    d = x.shape[-1]
    n = x.numel() // d
    dx = torch.empty_like(x)
    if n == 0:
        return dx, torch.zeros_like(weight) if weight_grad else None
    route = rms_route(d, x.dtype, (x.data_ptr(), weight.data_ptr(), g.data_ptr(), dx.data_ptr()))
    nb = _blocks(x, n, _VEC_BWD_BLOCKS_PER_SM if route == "vec" else 2)
    dw_part = torch.empty((nb, d), device=x.device, dtype=torch.float32) if weight_grad else None
    lib = _build.load("norms", _SIGNATURES)
    launch = lib.ps_rms_norm_bwd_vec if route == "vec" else lib.ps_rms_norm_bwd
    dtype = _build.DTYPE_CODES[x.dtype]
    err = launch(
        x.device.index, dtype, x.data_ptr(), weight.data_ptr(), rstd.data_ptr(),
        g.data_ptr(), dx.data_ptr(), None if dw_part is None else dw_part.data_ptr(),
        n, d, nb, _build.stream_ptr(x),
    )
    _build.check(lib, err, "rms_norm_bwd")
    rms_norm_bwd.launches += 1
    rms_norm_bwd.routes[route] += 1
    if dw_part is None:
        return dx, None
    dw = torch.empty_like(weight)
    err = lib.ps_rms_norm_dw_sum(
        x.device.index, dtype, dw_part.data_ptr(), dw.data_ptr(), nb, d, _build.stream_ptr(x))
    _build.check(lib, err, "rms_norm_bwd (dw sum)")
    return dx, dw


rms_norm_bwd.launches = 0
rms_norm_bwd.routes = {"vec": 0, "general": 0}


class LayerNormFn(torch.autograd.Function):
    """y = LayerNorm(x) * w + b through :func:`layer_norm_fwd`, with
    :func:`layer_norm_bwd` as its backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        y, mu, rstd = layer_norm_fwd(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, mu, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, mu, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(
            x, weight, mu, rstd, g.contiguous(),
            weight_grad=ctx.needs_input_grad[1] or ctx.needs_input_grad[2],
        )
        return dx, dw, db, None


class RMSNormFn(torch.autograd.Function):
    """y = RMSNorm(x) * w through :func:`rms_norm_fwd`, with
    :func:`rms_norm_bwd` as its backward."""

    @staticmethod
    def forward(ctx, x, weight, eps: float):
        y, rstd = rms_norm_fwd(x, weight, eps)
        ctx.save_for_backward(x, weight, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, rstd = ctx.saved_tensors
        dx, dw = rms_norm_bwd(
            x, weight, rstd, g.contiguous(), weight_grad=ctx.needs_input_grad[1]
        )
        return dx, dw, None
