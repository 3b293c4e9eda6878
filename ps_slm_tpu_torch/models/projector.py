"""Encoder -> LLM projectors.

Counterpart of ``ps_slm_tpu/models/projector.py``.  The port has the
published TASU projector, ``linear-silu`` (LayerNorm -> 2048 SiLU ->
llm_dim); the other five wait for ROADMAP.md queue 1 ("Long tail") and
raise.
"""

from __future__ import annotations

import torch
from torch import nn

from ps_slm_tpu_torch.models.layers import LayerNorm, linear_init_


class LinearSiLUProjector(nn.Module):
    def __init__(self, encoder_dim: int, llm_dim: int, bottleneck: int = 2048):
        super().__init__()
        self.norm = LayerNorm(encoder_dim)
        self.ffn1 = nn.Linear(encoder_dim, bottleneck)
        self.ffn2 = nn.Linear(bottleneck, llm_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ffn2(torch.nn.functional.silu(self.ffn1(self.norm(x))))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.norm.init_weights(generator)
        linear_init_(self.ffn1, generator)
        linear_init_(self.ffn2, generator)
        self.ffn2.bias.zero_()  # the reference zero-inits ffn[2].bias


def build_projector(model_cfg) -> nn.Module:
    name = model_cfg.encoder_projector
    if name != "linear-silu":
        raise NotImplementedError(
            f"projector {name!r} is not ported yet (ROADMAP.md queue 1, "
            "'Long tail'); only 'linear-silu' is"
        )
    return LinearSiLUProjector(model_cfg.encoder_dim, model_cfg.llm_dim)


def downsample_rate(model_cfg) -> int:
    """``k`` used for length bookkeeping."""
    if model_cfg.encoder_projector in ("linear-silu", "cross-attention"):
        return 1
    return model_cfg.encoder_projector_ds_rate
