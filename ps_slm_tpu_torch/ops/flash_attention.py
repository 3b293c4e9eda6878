"""Flash attention, forward and backward: the CUDA kernels, their plain
versions and the autograd Function over them.

Counterpart of ``ps_slm_tpu/ops/flash_attention.py``.  Layout q [B,S,Hq,D],
k/v [B,T,Hkv,D] with Hq % Hkv == 0.  Padding is a per-batch-row valid key
window ``[kv_start, kv_end)``; causality is a flag (query row s sees keys
t <= s).  Softmax statistics are fp32; a query row with no valid key gives
out = 0 and lse = ``NEG_INF``, and zero gradients.

:func:`flash_attention_fwd` launches ``csrc/flash_fwd.cu``,
:func:`flash_attention_dq` and :func:`flash_attention_dkv` launch
``csrc/flash_bwd.cu`` for CUDA tensors (head dim 128 only): bf16 runs the
forward, dq and dk/dv on the tensor cores, fp32 on fp32 FMAs, the dtype
alone deciding.  The forward has a second instantiation for latent
attention's expanded form, q/k head dim 192 and v head dim 128 (bf16 only,
``flash_fwd_mla_bf16_kernel``, counted in ``flash_attention_fwd.mla_launches``),
chosen by the head dims; there is no backward at those dims on the card
(ROADMAP queue C, training the deepseek_v3 configuration).  Each takes its
plain version (:func:`flash_attention_ref`, :func:`flash_attention_bwd_ref`)
only for CPU tensors.  :class:`FlashAttentionFn` saves ``q, k, v, kv_start,
kv_end, out, lse`` as the JAX custom VJP does, and its backward computes
delta = rowsum(dout * out) outside the kernels, as ``_flash_bwd`` does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ps_slm_tpu_torch import _build

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIM = 128  # the kernel's compiled head dim
MLA_DIMS = (192, 128)  # the latent-attention instantiation's q/k and v head dims

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # device, dtype, q, k, v, o, lse, kv_start, kv_end,
    # B, S, T, Hq, Hkv, head_dim, scale, causal, stream
    "ps_flash_fwd": (_I, _I, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _F, _I, _P),
    # device, dtype, q, k, v, o, lse, kv_start, kv_end,
    # B, S, T, Hq, Hkv, qk_dim, v_dim, scale, causal, stream
    "ps_flash_fwd_mla": (_I, _I, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
}
_BWD_SIGNATURES = {
    # device, dtype, q, k, v, dout, lse, delta, dq, kv_start, kv_end,
    # B, S, T, Hq, Hkv, head_dim, scale, causal, stream
    "ps_flash_bwd_dq": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _F, _I, _P),
    # device, dtype, q, k, v, dout, lse, delta, dk, dv, part (bf16's fp32
    # per-query-head scratch, NULL for fp32), kv_start, kv_end,
    # B, S, T, Hq, Hkv, head_dim, scale, causal, stream
    "ps_flash_bwd_dkv": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _F, _I, _P),
}


def window_from_mask(
    kv_mask: Optional[torch.Tensor], b: int, t: int, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B,T] bool -> (start [B], end [B]) int32 valid windows.

    The window spans the first to the last valid key of each row, so it is
    the mask itself only where the mask is contiguous.  Every mask on the
    serving path is: the encoder's prefix lengths and the merge's
    left-padded rows.  A row with no valid key gives (0, 0).
    """
    if kv_mask is None:
        start = torch.zeros(b, dtype=torch.int32, device=device)
        end = torch.full((b,), t, dtype=torch.int32, device=device)
        return start, end
    idx = torch.arange(t, device=kv_mask.device)
    any_valid = kv_mask.any(dim=1)
    start = torch.where(
        any_valid, torch.where(kv_mask, idx, t).amin(dim=1), 0
    ).to(torch.int32)
    end = torch.where(
        any_valid, torch.where(kv_mask, idx + 1, 0).amax(dim=1), 0
    ).to(torch.int32)
    return start, end


def _pair_mask(kv_start, kv_end, s: int, t: int, causal: bool) -> torch.Tensor:
    """[B,1,S,T] (or [B,1,1,T]) bool: the valid (query, key) pairs."""
    kv_pos = torch.arange(t, device=kv_start.device)
    valid = (kv_pos >= kv_start[:, None]) & (kv_pos < kv_end[:, None])  # [B,T]
    mask = valid[:, None, None, :]
    if causal:
        q_pos = torch.arange(s, device=kv_start.device)
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])[None, None]
    return mask


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_start: torch.Tensor, kv_end: torch.Tensor,
    *, causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: ``(out [B,S,Hq,Dv] in q.dtype,
    lse [B,Hq,S] fp32)``, with the whole [B,Hq,S,T] score matrix in fp32;
    v's head dim Dv may differ from q's and k's."""
    b, s, hq, _ = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    qf = q.float().transpose(1, 2)                                  # [B,Hq,S,D]
    kf = k.float().transpose(1, 2).repeat_interleave(rep, dim=1)     # [B,Hq,T,D]
    vf = v.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    scores = (qf @ kf.transpose(-1, -2)) * scale                     # [B,Hq,S,T]
    mask = _pair_mask(kv_start, kv_end, s, t, causal)
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (p @ vf) / l_safe
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l_safe))
    return out.transpose(1, 2).to(q.dtype).contiguous(), lse[..., 0]


def flash_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_start: torch.Tensor, kv_end: torch.Tensor,
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
    *, causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels (``_dq_kernel`` and
    ``_dkv_kernel`` math) from the forward's ``out`` and fp32 ``lse``:
    ``(dq, dk, dv)`` in the inputs' dtype, with the whole [B,Hq,S,T] score
    matrix in fp32.  p is a select on the valid pairs, so a query row with
    no valid key (lse = NEG_INF) gives zeros, never NaN."""
    b, s, hq, _ = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    qf = q.float().transpose(1, 2)                                  # [B,Hq,S,D]
    kf = k.float().transpose(1, 2).repeat_interleave(rep, dim=1)     # [B,Hq,T,D]
    vf = v.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    dof = dout.float().transpose(1, 2)
    delta = (dof * out.float().transpose(1, 2)).sum(-1, keepdim=True)  # [B,Hq,S,1]
    scores = (qf @ kf.transpose(-1, -2)) * scale
    mask = _pair_mask(kv_start, kv_end, s, t, causal)
    p = torch.where(mask, torch.exp(scores - lse[..., None]), 0.0)  # [B,Hq,S,T]
    dp = dof @ vf.transpose(-1, -2)
    ds = torch.where(mask, p * (dp - delta), 0.0)
    dq = (ds @ kf) * scale
    dk = ((ds.transpose(-1, -2) @ qf) * scale).reshape(b, hkv, rep, t, -1).sum(2)
    dv = (p.transpose(-1, -2) @ dof).reshape(b, hkv, rep, t, -1).sum(2)
    return (
        dq.transpose(1, 2).to(q.dtype).contiguous(),
        dk.transpose(1, 2).to(k.dtype).contiguous(),
        dv.transpose(1, 2).to(v.dtype).contiguous(),
    )


def _check_cuda(q, k, v, kv_start, kv_end, name: str = "flash_attention_fwd") -> None:
    if (q.shape[-1], v.shape[-1]) == MLA_DIMS and name != "flash_attention_fwd":
        raise NotImplementedError(
            f"{name}: no backward kernel at q/k head dim 192, v 128 (latent attention); "
            "training the deepseek_v3 configuration on the card waits for it (ROADMAP "
            "queue C)")
    if q.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, got {q.device}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    for x in (k, v):
        if x.device != q.device or x.dtype != q.dtype:
            raise TypeError(f"{name}: q, k, v must share device and dtype")
    for x in (kv_start, kv_end):
        if x.device != q.device or x.dtype != torch.int32:
            raise TypeError(f"{name}: windows must be int32 on q's device")
    if q.dim() != 4 or k.dim() != 4 or k.shape[:3] != v.shape[:3] or v.dim() != 4:
        raise ValueError(f"{name}: expected q [B,S,Hq,D], k [B,T,Hkv,D], v [B,T,Hkv,Dv]")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or (d, v.shape[3]) not in ((HEAD_DIM, HEAD_DIM),
                                                                     MLA_DIMS):
        raise ValueError(f"{name}: the kernels take head dims {HEAD_DIM} (q, k, v) or "
                         f"{MLA_DIMS[0]} (q, k) and {MLA_DIMS[1]} (v) only")
    if (d, v.shape[3]) == MLA_DIMS and q.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the latent-attention instantiation takes bfloat16 only")
    if k.shape[2] == 0 or hq % k.shape[2] != 0:
        raise ValueError(f"{name}: Hq={hq} is not a multiple of Hkv={k.shape[2]}")
    if kv_start.shape != (b,) or kv_end.shape != (b,):
        raise ValueError(f"{name}: windows must be [B]")
    if not all(x.is_contiguous() for x in (q, k, v, kv_start, kv_end)):
        raise ValueError(f"{name}: inputs must be contiguous")


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_start: torch.Tensor, kv_end: torch.Tensor,
    *, causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` as :func:`flash_attention_ref`.  ``kv_end`` must not
    exceed T (``window_from_mask`` guarantees it)."""
    if q.device.type == "cpu":
        return flash_attention_ref(
            q, k, v, kv_start, kv_end, causal=causal, scale=scale
        )
    _check_cuda(q, k, v, kv_start, kv_end)
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if (d, v.shape[3]) == MLA_DIMS:
        return _flash_fwd_mla(q, k, v, kv_start, kv_end, causal=causal, scale=scale)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), device=q.device, dtype=torch.float32)
    if b * s == 0:
        return out, lse
    lib = _build.load("flash_fwd", _SIGNATURES)
    err = lib.ps_flash_fwd(
        q.device.index, _build.DTYPE_CODES[q.dtype], q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        kv_start.data_ptr(), kv_end.data_ptr(), b, s, t, hq, hkv, d,
        float(scale), int(causal), _build.stream_ptr(q),
    )
    _build.check(lib, err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.mla_launches = 0


def _flash_fwd_mla(q, k, v, kv_start, kv_end, *, causal: bool, scale: float):
    """The latent-attention instantiation (q/k 192, v 128, bf16)."""
    b, s, hq, d = q.shape
    t, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, s, hq, dv), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, hq, s), device=q.device, dtype=torch.float32)
    if b * s == 0:
        return out, lse
    lib = _build.load("flash_fwd", _SIGNATURES)
    err = lib.ps_flash_fwd_mla(
        q.device.index, _build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), kv_start.data_ptr(), kv_end.data_ptr(), b, s, t, hq,
        hkv, d, dv, float(scale), int(causal), _build.stream_ptr(q),
    )
    _build.check(lib, err, "flash_attention_fwd (latent attention)")
    flash_attention_fwd.mla_launches += 1
    return out, lse


def _check_bwd(q, out, lse, dout, delta, name: str) -> None:
    for x in (out, dout):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise TypeError(f"{name}: out and dout must match q in shape, dtype and device")
    b, s, hq, _ = q.shape
    for x in (lse, delta):
        if x.shape != (b, hq, s) or x.dtype != torch.float32 or x.device != q.device:
            raise TypeError(f"{name}: lse and delta must be fp32 [B,Hq,S] on q's device")
    if not all(x.is_contiguous() for x in (out, dout, lse, delta)):
        raise ValueError(f"{name}: inputs must be contiguous")


def _bwd_args(q, k, v, dout, lse, delta, kv_start, kv_end):
    b, s, hq, d = q.shape
    return (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(),
    ), (kv_start.data_ptr(), kv_end.data_ptr(), b, s, k.shape[1], hq, k.shape[2], d)


def flash_attention_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_start: torch.Tensor, kv_end: torch.Tensor,
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, delta: torch.Tensor,
    *, causal: bool, scale: float,
) -> torch.Tensor:
    """dq as :func:`flash_attention_bwd_ref`; ``delta`` [B,Hq,S] fp32 is
    rowsum(dout * out), which the kernel reads (the plain version
    recomputes it from ``out``)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(
            q, k, v, kv_start, kv_end, out, lse, dout, causal=causal, scale=scale
        )[0]
    _check_cuda(q, k, v, kv_start, kv_end, "flash_attention_dq")
    _check_bwd(q, out, lse, dout, delta, "flash_attention_dq")
    dq = torch.empty_like(q)
    if q.shape[0] * q.shape[1] == 0:
        return dq
    ins, rest = _bwd_args(q, k, v, dout, lse, delta, kv_start, kv_end)
    lib = _build.load("flash_bwd", _BWD_SIGNATURES)
    err = lib.ps_flash_bwd_dq(
        q.device.index, _build.DTYPE_CODES[q.dtype], *ins, dq.data_ptr(), *rest,
        float(scale), int(causal), _build.stream_ptr(q),
    )
    _build.check(lib, err, "flash_attention_dq")
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_start: torch.Tensor, kv_end: torch.Tensor,
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, delta: torch.Tensor,
    *, causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) as :func:`flash_attention_bwd_ref`, summed over the query
    heads of each key/value head; ``delta`` as :func:`flash_attention_dq`.
    For bf16 the kernel writes each query head's fp32 partials to a scratch
    [2, B, T, Hq, D] allocated here, and sums them in a fixed order."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(
            q, k, v, kv_start, kv_end, out, lse, dout, causal=causal, scale=scale
        )[1:]
    _check_cuda(q, k, v, kv_start, kv_end, "flash_attention_dkv")
    _check_bwd(q, out, lse, dout, delta, "flash_attention_dkv")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if k.shape[0] * k.shape[1] == 0:
        return dk, dv
    ins, rest = _bwd_args(q, k, v, dout, lse, delta, kv_start, kv_end)
    part = None
    if q.dtype == torch.bfloat16:
        part = torch.empty((2, *k.shape[:2], q.shape[2], q.shape[3]),
                           device=q.device, dtype=torch.float32)
    lib = _build.load("flash_bwd", _BWD_SIGNATURES)
    err = lib.ps_flash_bwd_dkv(
        q.device.index, _build.DTYPE_CODES[q.dtype], *ins, dk.data_ptr(),
        dv.data_ptr(), None if part is None else part.data_ptr(), *rest,
        float(scale), int(causal), _build.stream_ptr(q),
    )
    _build.check(lib, err, "flash_attention_dkv")
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_start: torch.Tensor, kv_end: torch.Tensor,
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
    *, causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the two kernels on CUDA tensors (delta computed here,
    outside them), the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(
            q, k, v, kv_start, kv_end, out, lse, dout, causal=causal, scale=scale
        )
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    kw = dict(causal=causal, scale=scale)
    dq = flash_attention_dq(q, k, v, kv_start, kv_end, out, lse, dout, delta, **kw)
    dk, dv = flash_attention_dkv(q, k, v, kv_start, kv_end, out, lse, dout, delta, **kw)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """out = flash attention through :func:`flash_attention_fwd`, with
    :func:`flash_attention_bwd` as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, kv_start, kv_end, causal: bool, scale: float):
        out, lse = flash_attention_fwd(
            q, k, v, kv_start, kv_end, causal=causal, scale=scale
        )
        ctx.save_for_backward(q, k, v, kv_start, kv_end, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_start, kv_end, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, kv_start, kv_end, out, lse, dout.contiguous(),
            causal=ctx.causal, scale=ctx.scale,
        )
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, kv_mask: Optional[torch.Tensor] = None, causal: bool = False,
) -> torch.Tensor:
    """Flash attention over the public [B,S,H,D] layout, scale D ** -0.5,
    differentiable through :class:`FlashAttentionFn`: turns ``kv_mask``
    [B,T] into windows (see :func:`window_from_mask`) and returns ``out``."""
    b, _, _, d = q.shape
    start, end = window_from_mask(kv_mask, b, k.shape[1], q.device)
    return FlashAttentionFn.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), start, end, causal, d ** -0.5
    )
