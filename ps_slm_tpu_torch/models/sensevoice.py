"""SenseVoiceSmall encoder (SANM attention + FSMN memory + CTC head).

Counterpart of ``ps_slm_tpu/models/sensevoice.py``: ``encoders0`` (input
width -> output width, no residual around its attention when the widths
differ), ``num_blocks - 1`` further ``encoders``, ``after_norm``,
``tp_blocks`` timestamp-predictor ``tp_encoders``, ``tp_norm``, the CTC
head ``ctc_lo`` and the query-token table ``query_embed``.  One module per
layer; attention goes to the flash kernel with the padding as prefix
lengths; every LayerNorm runs with fp32 statistics.

Under tensor parallelism (``parallel/mesh.py`` sets ``SANMLayer.tp``, a
``parallel.tensor.Shards``) a layer holds its heads' rows of ``qkv`` (q,
k and v of heads ``[r h/T, (r+1) h/T)``, ``parallel.tensor.qkv_rows``)
and of ``w1``, and the matching columns of ``out`` and ``w2``; the FSMN
(its kernel whole on every rank) runs on this rank's channels of v, its
output put into those channels of ``out``'s partial sum, so one sum over
the ranks gives ``out(att) + fsmn``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ps_slm_tpu_torch.models.layers import LayerNorm, linear_init_, normal_, run_block, uniform_
from ps_slm_tpu_torch.ops.attention import attention
from ps_slm_tpu_torch.parallel.tensor import copy_in, parallel_mlp, reduce_out


@dataclass(frozen=True)
class SenseVoiceConfig:
    input_size: int = 560          # 80 mel x LFR 7
    output_size: int = 512
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 50
    tp_blocks: int = 20            # timestamp-predictor blocks
    kernel_size: int = 11
    sanm_shift: int = 0
    vocab_size: int = 25055
    blank_id: int = 0
    n_query_embed: int = 16

    @staticmethod
    def tiny(**kw) -> "SenseVoiceConfig":
        base = dict(
            input_size=24, output_size=16, attention_heads=2,
            linear_units=32, num_blocks=3, tp_blocks=2, kernel_size=5,
            vocab_size=11,
        )
        base.update(kw)
        return SenseVoiceConfig(**base)


def sinusoidal_pe(t: int, depth: int, device) -> torch.Tensor:
    """[t, depth] fp32; positions are 1-based, timescale increment
    log(10000) / (depth/2 - 1)."""
    positions = torch.arange(1, t + 1, device=device, dtype=torch.float32)
    inc = math.log(10000.0) / (depth / 2 - 1)
    inv = torch.exp(torch.arange(depth // 2, device=device, dtype=torch.float32) * -inc)
    scaled = positions[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)


def fsmn_block(v: torch.Tensor, weight: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Depthwise FSMN memory: mask, pad (k-1)//2 left and the rest right,
    depthwise conv, inner residual, mask again.  v [B,T,C]; weight
    [C,1,k]; mask [B,T] in v.dtype."""
    v = v * mask[..., None]
    k = weight.shape[-1]
    left = (k - 1) // 2
    x = F.pad(v.transpose(1, 2), (left, k - 1 - left))
    x = F.conv1d(x, weight, groups=v.shape[-1]).transpose(1, 2)
    return (x + v) * mask[..., None]


class SANMLayer(nn.Module):
    """EncoderLayerSANM, pre-norm."""

    def __init__(self, in_size: int, cfg: SenseVoiceConfig):
        super().__init__()
        d = cfg.output_size
        self.in_size, self.size, self.heads = in_size, d, cfg.attention_heads
        self.norm1 = LayerNorm(in_size)
        self.norm2 = LayerNorm(d)
        self.qkv = nn.Linear(in_size, 3 * d)
        self.out = nn.Linear(d, d)
        self.fsmn = nn.Conv1d(d, d, cfg.kernel_size, groups=d, bias=False)
        self.w1 = nn.Linear(d, cfg.linear_units)
        self.w2 = nn.Linear(cfg.linear_units, d)
        # this rank's place in a tensor-parallel group (parallel/mesh.py)
        self.tp = None

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        tp = self.tp
        n = 1 if tp is None else tp.size
        d, h = self.size // n, self.heads // n          # this rank's channels and heads
        residual = x
        y = self.norm1(x)
        if tp is not None:
            y = copy_in(y, tp)
        q, k, v = self.qkv(y).split(d, dim=-1)
        fsmn_w = self.fsmn.weight if tp is None else self.fsmn.weight[tp.block(self.size)]
        fsmn = fsmn_block(v, fsmn_w, mask.to(v.dtype))
        att = attention(
            q.reshape(b, t, h, d // h), k.reshape(b, t, h, d // h),
            v.reshape(b, t, h, d // h), kv_mask=mask, causal=False,
        ).reshape(b, t, d)
        if tp is None:
            att = self.out(att) + fsmn
        else:
            lo = tp.rank * d
            part = F.linear(att, self.out.weight) + F.pad(fsmn, (lo, self.size - lo - d))
            att = reduce_out(part, tp) + self.out.bias
        x = att if self.in_size != self.size else residual + att
        y = self.norm2(x)
        if tp is None:
            return x + self.w2(torch.relu(self.w1(y)))
        return x + parallel_mlp(y, self.w1, torch.relu, self.w2, tp)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.norm1.init_weights(generator)
        self.norm2.init_weights(generator)
        for lin in (self.qkv, self.out):
            linear_init_(lin, generator)
        uniform_(self.fsmn.weight, 1.0 / math.sqrt(self.size), generator)
        for lin in (self.w1, self.w2):
            linear_init_(lin, generator)


class SenseVoiceEncoder(nn.Module):
    """SenseVoiceEncoderSmall + CTC head + query-token table."""

    def __init__(self, cfg: SenseVoiceConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.output_size
        self.encoders0 = SANMLayer(cfg.input_size, cfg)
        self.encoders = nn.ModuleList(
            SANMLayer(d, cfg) for _ in range(cfg.num_blocks - 1)
        )
        self.after_norm = LayerNorm(d)
        self.tp_encoders = nn.ModuleList(SANMLayer(d, cfg) for _ in range(cfg.tp_blocks))
        self.tp_norm = LayerNorm(d)
        self.ctc_lo = nn.Linear(d, cfg.vocab_size)
        self.query_embed = nn.Parameter(torch.empty(cfg.n_query_embed, cfg.input_size))
        # activation checkpointing of each block while gradients are recorded
        # (a frozen encoder records none, so it changes nothing there)
        self.remat = False

    def forward(
        self, xs: torch.Tensor, lens: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """xs [B,T,input_size] (queries already prepended), lens [B] ->
        (hidden [B,T,output_size], lens)."""
        cfg = self.cfg
        b, t, _ = xs.shape
        mask = torch.arange(t, device=xs.device)[None, :] < lens[:, None]
        xs = xs * (cfg.output_size ** 0.5)
        pe = sinusoidal_pe(t, cfg.input_size, xs.device)
        xs = (xs.float() + pe[None]).to(xs.dtype)
        xs = self.encoders0(xs, mask)
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.encoders:
            xs = run_block(layer, remat, xs, mask)
        xs = self.after_norm(xs)
        for layer in self.tp_encoders:
            xs = run_block(layer, remat, xs, mask)
        return self.tp_norm(xs), lens

    def ctc_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.ctc_lo(hidden)

    def query_embedding(self, ids: Sequence[int]) -> torch.Tensor:
        return self.query_embed[torch.as_tensor(ids, device=self.query_embed.device)]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for layer in (self.encoders0, *self.encoders, *self.tp_encoders):
            layer.init_weights(generator)
        self.after_norm.init_weights(generator)
        self.tp_norm.init_weights(generator)
        linear_init_(self.ctc_lo, generator)
        normal_(self.query_embed, 1.0, generator)
