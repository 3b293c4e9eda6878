"""Attention ops: the flash-kernel entry point and the plain reference.

Counterpart of ``ps_slm_tpu/ops/attention.py``.  GQA layout
q [B,S,Hq,D], k/v [B,T,Hkv,D] with Hq % Hkv == 0; padding via ``kv_mask``
[B,T] (True = valid).

* :func:`attention` is the full-sequence entry point of the encoder, the
  LLM prefill and the training forward.  It always goes to
  :func:`flash_attention` (the CUDA kernels, forward and backward, on CUDA
  tensors, their plain versions on CPU tensors); the TPU's size gate is
  not carried over.
* :func:`mha_reference` is plain PyTorch with ``q_offset`` for cached
  decoding; :func:`decode_attention` uses it for each step against the KV
  cache, as the JAX package does (no kernel there either).
"""

from __future__ import annotations

from typing import Optional

import torch

from ps_slm_tpu_torch.ops.flash_attention import NEG_INF, flash_attention


def mha_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, kv_mask: Optional[torch.Tensor] = None, causal: bool = False,
    q_offset: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention with an fp32 softmax; output in q.dtype.

    causal masks keys with kv_pos > q_pos + q_offset (``q_offset`` scalar or
    [B]).  Rows with no valid key give zeros.  GQA groups the query heads
    ([B,S,Hkv,rep,D]) instead of repeating k/v.
    """
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, d)

    mask = None
    if kv_mask is not None:
        mask = kv_mask[:, None, None, None, :]                      # [B,1,1,1,T]
    if causal:
        q_pos = torch.arange(s, device=q.device)[None, :, None]     # [1,S,1]
        if q_offset is not None:
            off = torch.as_tensor(q_offset, device=q.device).reshape(-1)
            q_pos = q_pos + off.expand(b)[:, None, None]
        kv_pos = torch.arange(t, device=q.device)[None, None, :]
        causal_mask = (kv_pos <= q_pos)[:, None, None]              # [B|1,1,1,S,T]
        mask = causal_mask if mask is None else mask & causal_mask

    logits = torch.einsum("bskrd,btkd->bkrst", qg, k).float() * d ** -0.5
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if mask is not None:
        probs = torch.where(mask, probs, 0.0)
    out = torch.einsum("bkrst,btkd->bskrd", probs.to(v.dtype), v)
    return out.reshape(b, s, hq, d).to(q.dtype)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None, *, causal: bool = False,
) -> torch.Tensor:
    """Full-sequence attention (S == T, query row s at key position s).

    The mask reaches the kernel as a per-row [start, end) window, which is
    exact for the contiguous masks of the serving path (see
    :func:`~ps_slm_tpu_torch.ops.flash_attention.window_from_mask`).
    """
    if q.shape[1] != k.shape[1]:
        raise ValueError(
            f"attention is full-sequence (S == T), got S={q.shape[1]} "
            f"T={k.shape[1]}; use mha_reference with q_offset"
        )
    return flash_attention(q, k, v, kv_mask=kv_mask, causal=causal)


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    kv_mask: torch.Tensor,
) -> torch.Tensor:
    """One decode step against a KV cache.

    q [B,1,Hq,D]; caches [B,Tmax,Hkv,D]; ``kv_mask`` [B,Tmax] marks the
    written, valid cells (the new token's k/v already written).  The JAX
    function takes a cache length instead; a mask also covers the holes
    that left padding leaves at the front of a row.
    """
    return mha_reference(q, k_cache, v_cache, kv_mask=kv_mask, causal=False)
