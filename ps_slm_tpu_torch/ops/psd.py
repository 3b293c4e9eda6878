"""PSD (posterior-synchronous downsampling) in plain PyTorch.

Counterpart of ``ps_slm_tpu/ops/psd.py``.  Per row:

  1. runs of adjacent identical non-blank argmax frames merge into one
     frame, the mean of the run; blank frames stay single (a boundary is
     forced at frame 0, at every blank and at the frame after a blank);
  2. merged frames whose mean blank probability is >= the threshold drop;
  3. the survivors are left-compacted and zero-padded to the input's T.

The JAX package phrases the segment reductions as one-hot [T,T] matmuls for
the TPU's matrix unit.  Here a segment is a run of consecutive frames, so
its sum is a sorted segment reduction (``torch.segment_reduce`` over the
batch's frames at once): each segment is summed in frame order, the same
bits on every call on either device, where a scatter (``index_add_``) adds
with atomics in no fixed order on CUDA tensors.
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

    # frames per (row, segment) slot, t + 1 a row: the slots of the
    # flattened frames are non-decreasing, so each slot's frames are one
    # run of them (integer counts: the scatter's order does not matter)
    frames = torch.zeros(b, t + 1, device=dev, dtype=torch.int64)
    frames.scatter_add_(1, seg, torch.ones_like(seg))
    lengths = frames.reshape(-1)

    def seg_sum(v):
        return torch.segment_reduce(v, "sum", lengths=lengths, unsafe=True)

    seg_feat = seg_sum(feats.reshape(b * t, d).float()).view(b, t + 1, d)[:, :t]
    seg_blank = seg_sum(blank_prob.reshape(-1)).view(b, t + 1)[:, :t]
    seg_count = frames[:, :t].float()                     # slots < t hold valid frames only
    denom = seg_count.clamp(min=1.0)
    keep = (seg_count > 0) & (seg_blank / denom < blank_threshold)

    dest = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    rows = torch.arange(b, device=dev)[:, None].expand(b, t)
    out = torch.zeros(b, t, d, device=dev, dtype=feats.dtype)
    out[rows[keep], dest[keep]] = (seg_feat / denom[..., None])[keep].to(feats.dtype)
    return out, keep.sum(dim=1).to(torch.int32)
