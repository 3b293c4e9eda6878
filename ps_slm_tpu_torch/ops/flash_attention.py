"""Flash-attention forward: the CUDA kernel and its plain version.

Counterpart of ``ps_slm_tpu/ops/flash_attention.py`` (forward only; the dq
and dkv kernels come with the training slice).  Layout q [B,S,Hq,D],
k/v [B,T,Hkv,D] with Hq % Hkv == 0.  Padding is a per-batch-row valid key
window ``[kv_start, kv_end)``; causality is a flag (query row s sees keys
t <= s).  Softmax statistics are fp32; a query row with no valid key gives
out = 0 and lse = ``NEG_INF``.

:func:`flash_attention_fwd` launches ``csrc/flash_fwd.cu`` for CUDA tensors
(head dim 128 only) and takes :func:`flash_attention_ref` only for CPU
tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ps_slm_tpu_torch import _build

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIM = 128  # the kernel's compiled head dim

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # device, dtype, q, k, v, o, lse, kv_start, kv_end,
    # B, S, T, Hq, Hkv, head_dim, scale, causal, stream
    "ps_flash_fwd": (_I, _I, _P, _P, _P, _P, _P, _P, _P,
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


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_start: torch.Tensor, kv_end: torch.Tensor,
    *, causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: ``(out [B,S,Hq,D] in q.dtype,
    lse [B,Hq,S] fp32)``, with the whole [B,Hq,S,T] score matrix in fp32."""
    b, s, hq, _ = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    qf = q.float().transpose(1, 2)                                  # [B,Hq,S,D]
    kf = k.float().transpose(1, 2).repeat_interleave(rep, dim=1)     # [B,Hq,T,D]
    vf = v.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    scores = (qf @ kf.transpose(-1, -2)) * scale                     # [B,Hq,S,T]

    kv_pos = torch.arange(t, device=q.device)
    valid = (kv_pos >= kv_start[:, None]) & (kv_pos < kv_end[:, None])  # [B,T]
    mask = valid[:, None, None, :]
    if causal:
        q_pos = torch.arange(s, device=q.device)
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])[None, None]
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (p @ vf) / l_safe
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l_safe))
    return out.transpose(1, 2).to(q.dtype).contiguous(), lse[..., 0]


def _check_cuda(q, k, v, kv_start, kv_end) -> None:
    name = "flash_attention_fwd"
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
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: expected q [B,S,Hq,D], k/v [B,T,Hkv,D]")
    b, _, hq, d = q.shape
    if d != HEAD_DIM or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: the kernel takes head dim {HEAD_DIM} only")
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


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, kv_mask: Optional[torch.Tensor] = None, causal: bool = False,
) -> torch.Tensor:
    """Flash attention over the public [B,S,H,D] layout, scale D ** -0.5:
    turns ``kv_mask`` [B,T] into windows (see :func:`window_from_mask`) and
    returns ``out``."""
    b, _, _, d = q.shape
    start, end = window_from_mask(kv_mask, b, k.shape[1], q.device)
    out, _ = flash_attention_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(), start, end,
        causal=causal, scale=d ** -0.5,
    )
    return out
