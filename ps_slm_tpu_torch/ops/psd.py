"""PSD (posterior-synchronous downsampling) in plain PyTorch.

Counterpart of ``ps_slm_tpu/ops/psd.py``.  Per row:

  1. runs of adjacent identical non-blank argmax frames merge into one
     frame, the mean of the run; blank frames stay single (a boundary is
     forced at frame 0, at every blank and at the frame after a blank);
  2. merged frames whose mean blank probability is >= the threshold drop;
  3. the survivors are left-compacted and zero-padded to the input's T.

The JAX package phrases the segment reductions as one-hot [T,T] matmuls for
the TPU's matrix unit; here they are ``index_add_`` scatters over the batch
at once, which give the same sums in another order.
"""

from __future__ import annotations

from typing import Tuple

import torch


def psd(
    feats: torch.Tensor,       # [B, T, D]  features to pool
    lens: torch.Tensor,        # [B]
    posterior: torch.Tensor,   # [B, T, V]  probabilities
    *,
    blank_id: int = 0,
    blank_threshold: float = 0.9,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (pooled [B,T,D] zero-padded, new_lens [B] int32)."""
    b, t, d = feats.shape
    dev = feats.device
    ids = posterior.argmax(dim=-1)                       # first max, [B,T]
    blank_prob = posterior[..., blank_id].float()
    pos = torch.arange(t, device=dev)
    valid = pos[None, :] < lens.to(dev)[:, None]

    is_blank = ids == blank_id
    boundary = torch.ones_like(is_blank)
    boundary[:, 1:] = (ids[:, 1:] != ids[:, :-1]) | is_blank[:, 1:] | is_blank[:, :-1]
    seg = torch.cumsum(boundary.to(torch.int64), dim=1) - 1
    seg = torch.where(valid, seg, t)                      # slot t collects padding

    # segment sums over flattened (row, segment) slots, t + 1 per row
    slot = (seg + torch.arange(b, device=dev)[:, None] * (t + 1)).reshape(-1)
    seg_feat = torch.zeros(b * (t + 1), d, device=dev, dtype=torch.float32)
    seg_feat.index_add_(0, slot, feats.reshape(b * t, d).float())
    seg_count = torch.zeros(b * (t + 1), device=dev, dtype=torch.float32)
    seg_count.index_add_(0, slot, valid.reshape(-1).float())
    seg_blank = torch.zeros(b * (t + 1), device=dev, dtype=torch.float32)
    seg_blank.index_add_(0, slot, (blank_prob * valid).reshape(-1))

    seg_feat = seg_feat.view(b, t + 1, d)[:, :t]
    seg_count = seg_count.view(b, t + 1)[:, :t]
    seg_blank = seg_blank.view(b, t + 1)[:, :t]
    denom = seg_count.clamp(min=1.0)
    keep = (seg_count > 0) & (seg_blank / denom < blank_threshold)

    dest = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    rows = torch.arange(b, device=dev)[:, None].expand(b, t)
    out = torch.zeros(b, t, d, device=dev, dtype=feats.dtype)
    out[rows[keep], dest[keep]] = (seg_feat / denom[..., None])[keep].to(feats.dtype)
    return out, keep.sum(dim=1).to(torch.int32)
