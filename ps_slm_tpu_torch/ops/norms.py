"""LayerNorm and RMSNorm, forward and backward: CUDA kernels, their plain
versions and the autograd Functions over them.

Counterpart of ``ps_slm_tpu/ops/norms.py``.  Statistics and gradient sums
are fp32; x, the weights, y and dx are bf16 or fp32.

``layer_norm_fwd``, ``rms_norm_fwd``, ``layer_norm_bwd`` and
``rms_norm_bwd`` launch the kernels of ``csrc/norms.cu`` for CUDA tensors
and take the plain versions (``*_ref``) only for CPU tensors.  There is no
width gate: every CUDA call goes through a kernel, at any d.  The RMSNorm
wrappers pick one of two kernel routes with :func:`rms_route` (a warp per
row from 16-byte loads, or a block per row for any width and alignment),
the LayerNorm forward one of four with :func:`ln_route` (the same two,
and for rows too wide for a warp a block that reads each row once and
keeps it on chip: in shared memory where four rows fit there, else in
registers), the LayerNorm backward one of two with :func:`ln_bwd_route`
(a warp per row, or a block an SM for any width), and each counts its
launches per route in ``.routes``.  Every weight gradient is summed from
per-block partial rows by a kernel in a fixed order (the same bits from
call to call).
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
    # the vectorised route's forward: device, dtype, x, w, b (null:
    # RMSNorm), y, mu (null: RMSNorm), rstd, n, d, eps, n_blocks, stream
    "ps_norm_fwd_vec": (_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P),
    # the LayerNorm's staged and held routes: device, dtype, x, w, b, y, mu,
    # rstd, n, d, eps, n_blocks, stream
    "ps_layer_norm_fwd_staged": (_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P),
    "ps_layer_norm_fwd_held": (_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P),
    # device, dtype, x, w, rstd, g, dx, dw_part (null: no dw), n, d,
    # n_blocks, stream
    "ps_rms_norm_bwd_vec": (_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # device, dtype, dw_part, dw, n_blocks, d, stream
    "ps_rms_norm_dw_sum": (_I, _I, _P, _P, _I, _I, _P),
    # device, dtype, dw_part, db_part, dw, db, n_blocks, d, stream
    "ps_layer_norm_dwdb_sum": (_I, _I, _P, _P, _P, _P, _I, _I, _P),
}
# csrc/ln_bwd.cu, the LayerNorm backward's vectorised route: device, dtype,
# x, w, mu, rstd, g, dx, dw_part, db_part (both null: no dw / db), n, d,
# n_blocks, stream
_LN_BWD_SIGNATURES = {
    "ps_layer_norm_bwd_vec": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
}

# The kernels' vectorised route takes rows of at most this many bytes
# (csrc/vec.cuh: VEC_MAX_CHUNKS = 7 16-byte chunks a lane, 32 lanes)
VEC_ROW_BYTES = 7 * 32 * 16
# The LayerNorm forward's staged route takes wider rows whose four buffers
# of 16-byte granules (w, b and a ring of two rows) fit in this much
# shared memory (csrc/norms.cu: DYN_SMEM_MAX, ln_stage_bytes)
LN_STAGED_SMEM_BYTES = 225 * 1024
# blocks of 4 warps an SM for the vectorised kernels, each block a run of
# consecutive rows: as many as the kernels' registers let an SM hold at
# 1536 wide in bf16 (151 a thread forward, 218-232 backward), the fastest
# of 1, 2, 3, 4, 6 and 8 on the H100
_VEC_FWD_BLOCKS_PER_SM = 3
_VEC_BWD_BLOCKS_PER_SM = 2
# the LayerNorm forward's vectorised route at the encoder's 512 and 560
# wide rows: the fastest of 1, 2, 3, 4, 6 and 8 on the H100 over both
# widths and dtypes (chip_smoke.py --variants)
_VEC_LN_BLOCKS_PER_SM = 4
# the LayerNorm backward's vectorised route: blocks of at least 4 rows (a
# warp each: fewer partial rows to write and sum), at most 2 an SM; at the
# encoder's 760 x 560 / 512 rows and the q-former's 256 x 768 / 1536, in
# both dtypes, within the spread of the fastest of 1, 2, 3, 4, 6 and 8 an
# SM with and without the 4-row floor on the H100 (chip_smoke.py
# --variants)
_VEC_LN_BWD_BLOCKS_PER_SM = 2
_VEC_LN_BWD_MIN_ROWS = 4


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


def ln_route(d: int, dtype: torch.dtype, ptrs) -> str:
    """The LayerNorm forward's kernel route for rows of ``d`` elements of
    ``dtype`` at the data pointers ``ptrs`` (x, w, b and y).  Rows wider
    than ``VEC_ROW_BYTES``, at any alignment, are read once and kept on
    chip by a block: ``"staged"`` in shared memory where four buffers of a
    row's 16-byte granules fit in ``LN_STAGED_SMEM_BYTES``, else ``"held"``
    in registers.  Narrower rows follow :func:`rms_route`'s rule, ``"vec"``
    or ``"general"``."""
    row = d * dtype.itemsize
    if row <= VEC_ROW_BYTES:
        return rms_route(d, dtype, ptrs)
    stage = (row + 15 + 15) // 16 * 16    # a row's granules at any shift
    return "staged" if 4 * stage <= LN_STAGED_SMEM_BYTES else "held"


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
    ptrs = (x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr())
    route = ln_route(d, x.dtype, ptrs)
    args = (x.device.index, _build.DTYPE_CODES[x.dtype], *ptrs, mu.data_ptr(),
            rstd.data_ptr(), n, d, eps)
    if route == "vec":
        err = lib.ps_norm_fwd_vec(
            *args, _blocks(x, n, _VEC_LN_BLOCKS_PER_SM), _build.stream_ptr(x))
    elif route == "staged":   # one block an SM: its shared memory
        err = lib.ps_layer_norm_fwd_staged(*args, _blocks(x, n, 1), _build.stream_ptr(x))
    elif route == "held":     # one block an SM: its registers
        err = lib.ps_layer_norm_fwd_held(*args, _blocks(x, n, 1), _build.stream_ptr(x))
    else:
        err = lib.ps_layer_norm_fwd(*args, _build.stream_ptr(x))
    _build.check(lib, err, "layer_norm_fwd")
    layer_norm_fwd.launches += 1
    layer_norm_fwd.routes[route] += 1
    return y, mu, rstd


layer_norm_fwd.launches = 0
layer_norm_fwd.routes = {"vec": 0, "staged": 0, "held": 0, "general": 0}


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
    dev, dtype = x.device.index, _build.DTYPE_CODES[x.dtype]
    if route == "vec":
        err = lib.ps_norm_fwd_vec(
            dev, dtype, ptrs[0], ptrs[1], None, ptrs[2], None, rstd.data_ptr(), n, d, eps,
            _blocks(x, n, _VEC_FWD_BLOCKS_PER_SM), _build.stream_ptr(x))
    else:
        err = lib.ps_rms_norm_fwd(dev, dtype, *ptrs, rstd.data_ptr(), n, d, eps,
                                  _build.stream_ptr(x))
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


def _blocks(x: torch.Tensor, n: int, per_sm: int, min_rows: int = 1) -> int:
    """Blocks of a launch that gives each block a run of consecutive rows
    (for a backward, the rows of its partial-sum buffers): ``per_sm`` an
    SM, fewer where there are fewer rows, and fewer still where a block
    would get fewer than ``min_rows`` rows."""
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    per = max(-(-n // (per_sm * sms)), min_rows)
    return -(-n // per)


def ln_bwd_route(d: int, dtype: torch.dtype, ptrs) -> str:
    """The LayerNorm backward's kernel route for rows of ``d`` elements of
    ``dtype`` at the data pointers ``ptrs`` (x, w, g and dx): ``"vec"``, a
    warp per row, by :func:`rms_route`'s rule (a whole number of 16-byte
    chunks, at most ``VEC_ROW_BYTES``, every pointer 16-byte aligned); else
    ``"wide"``, a block an SM walking its rows one at a time, for any width
    and alignment (the projector's 25 055)."""
    return "vec" if rms_route(d, dtype, ptrs) == "vec" else "wide"


def layer_norm_bwd(
    x: torch.Tensor, weight: torch.Tensor, mu: torch.Tensor, rstd: torch.Tensor,
    g: torch.Tensor, *, weight_grad: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """LayerNorm backward: ``(dx, dw, db)`` as :func:`layer_norm_bwd_ref`.

    dx is always computed.  The kernel of the route :func:`ln_bwd_route`
    gives writes dw/db as per-block partial rows, which a second kernel
    sums in a fixed order, so dw and db are the same bits from call to
    call.  ``weight_grad=False`` (frozen weights) returns None for both:
    the vectorised route then computes no dw/db and allocates no partial
    rows; the wide one still writes them, unsummed."""
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
    ptrs = (x.data_ptr(), weight.data_ptr(), g.data_ptr(), dx.data_ptr())
    route = ln_bwd_route(d, x.dtype, ptrs)
    vec = route == "vec"
    # the wide kernel's partial rows fill its SM's shared memory: one block an SM
    nb = (_blocks(x, n, _VEC_LN_BWD_BLOCKS_PER_SM, _VEC_LN_BWD_MIN_ROWS) if vec
          else _blocks(x, n, 1))
    part = (torch.empty((2, nb, d), device=x.device, dtype=torch.float32)
            if weight_grad or not vec else None)
    dw_part, db_part = (None, None) if part is None else (part[0].data_ptr(), part[1].data_ptr())
    lib = _build.load("norms", _SIGNATURES)
    dev, dtype = x.device.index, _build.DTYPE_CODES[x.dtype]
    if vec:
        vlib = _build.load("ln_bwd", _LN_BWD_SIGNATURES)
        err = vlib.ps_layer_norm_bwd_vec(
            dev, dtype, ptrs[0], ptrs[1], mu.data_ptr(), rstd.data_ptr(), ptrs[2], ptrs[3],
            dw_part, db_part, n, d, nb, _build.stream_ptr(x))
        _build.check(vlib, err, "layer_norm_bwd")
    else:
        err = lib.ps_layer_norm_bwd(
            dev, dtype, ptrs[0], ptrs[1], mu.data_ptr(), rstd.data_ptr(), ptrs[2], ptrs[3],
            dw_part, db_part, n, d, nb, _build.stream_ptr(x))
        _build.check(lib, err, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    layer_norm_bwd.routes[route] += 1
    if not weight_grad:
        return dx, None, None
    dw, db = torch.empty_like(weight), torch.empty_like(weight)
    err = lib.ps_layer_norm_dwdb_sum(dev, dtype, dw_part, db_part, dw.data_ptr(), db.data_ptr(),
                                     nb, d, _build.stream_ptr(x))
    _build.check(lib, err, "layer_norm_bwd (dw, db sum)")
    return dx, dw, db


layer_norm_bwd.launches = 0
layer_norm_bwd.routes = {"vec": 0, "wide": 0}


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
        # the kernels read rows in place: a strided view (an expanded
        # q-former query) is copied once, on either device
        x = x.contiguous()
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
        x = x.contiguous()
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
