"""Masked token accuracy.

Counterpart of ``ps_slm_tpu/utils/metric.py``.
"""

from __future__ import annotations

import torch


def compute_accuracy(
    pad_outputs: torch.Tensor,   # [B, L] predicted ids
    pad_targets: torch.Tensor,   # [B, L] target ids
    ignore_label: int = -100,
) -> torch.Tensor:
    """Accuracy over the positions whose target is not ``ignore_label``
    (fp32 scalar; 0 when there are none)."""
    mask = pad_targets != ignore_label
    num = ((pad_outputs == pad_targets) & mask).sum()
    return num.float() / mask.sum().clamp(min=1).float()
