"""Qwen2 (Qwen2.5-1.5B-Instruct's ``config.json``) over one sequence,
float32.

Each decoder layer: RMSNorm (eps 1e-6), q/k/v projections with biases,
rotary embeddings on q and k (rotate-half, theta ``rope_theta``, positions
from 0), causal softmax attention in which each key/value head serves
``heads / kv_heads`` consecutive query heads, scaled by head size's
inverse root, the output projection and its residual; RMSNorm, SwiGLU
(``silu(gate) * up``, then down) and its residual.  A final RMSNorm; the
logits use the tied embedding table.  ``int8_weights`` gives the
projections of the int8 weight-only recipe: symmetric codes per output
channel, scale = max |w| / 127, round half to even.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.precision import mm

PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def rms_norm(x, w, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [heads, T, d] at positions 0..T-1."""
    t, d = x.shape[1], x.shape[2]
    inv = theta ** (-torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    ang = torch.arange(t, device=x.device, dtype=torch.float32)[:, None] * inv[None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    a, b = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def forward(w: Dict[str, torch.Tensor], cfg: Dict, embeds: torch.Tensor) -> torch.Tensor:
    """Hidden states after the final norm, [T, hidden], of embeds [T, hidden]."""
    t = embeds.shape[0]
    nh, nkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    causal = torch.ones(t, t, dtype=torch.bool, device=embeds.device).tril()
    x = embeds
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        y = rms_norm(x, w[p + "input_layernorm.weight"], cfg["rms_norm_eps"])
        q = (mm(y, w[p + "q_proj.weight"].T) + w[p + "q_proj.bias"]).reshape(t, nh, hd).transpose(0, 1)
        k = (mm(y, w[p + "k_proj.weight"].T) + w[p + "k_proj.bias"]).reshape(t, nkv, hd).transpose(0, 1)
        v = (mm(y, w[p + "v_proj.weight"].T) + w[p + "v_proj.bias"]).reshape(t, nkv, hd).transpose(0, 1)
        q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
        k = k.repeat_interleave(nh // nkv, dim=0)
        v = v.repeat_interleave(nh // nkv, dim=0)
        s = mm(q, k.transpose(1, 2)) / math.sqrt(hd)
        att = mm(torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1), v)
        x = x + mm(att.transpose(0, 1).reshape(t, nh * hd), w[p + "o_proj.weight"].T)
        y = rms_norm(x, w[p + "post_attention_layernorm.weight"], cfg["rms_norm_eps"])
        gate = F.silu(mm(y, w[p + "gate_proj.weight"].T))
        x = x + mm(gate * mm(y, w[p + "up_proj.weight"].T), w[p + "down_proj.weight"].T)
    return rms_norm(x, w["norm.weight"], cfg["rms_norm_eps"])


def logits(w: Dict[str, torch.Tensor], hidden: torch.Tensor) -> torch.Tensor:
    return mm(hidden, w["embed_tokens.weight"].T)


def int8_weights(w: Dict[str, torch.Tensor], cfg: Dict) -> Dict[str, torch.Tensor]:
    """The weights with every projection replaced by its int8 codes times
    their scale (float32)."""
    out = dict(w)
    for i in range(cfg["num_hidden_layers"]):
        for name in PROJECTIONS:
            key = f"layers.{i}.{name}.weight"
            m = w[key]
            scale = m.abs().amax(dim=1, keepdim=True).clamp(min=1e-8) \
                / torch.tensor(127.0, device=m.device)
            out[key] = torch.clamp(torch.round(m / scale), -127, 127) * scale
    return out
