"""SenseVoiceSmall's encoder (funasr ``SenseVoiceEncoderSmall``) over one
utterance, float32.

The four query embeddings go before the frames; the input is scaled by
sqrt(output width) and gets a sinusoidal position encoding (positions
from 1, ``sin`` then ``cos`` halves, timescale step ln(10 000) / (w/2 - 1)).
Each SANM block is pre-norm: LayerNorm, one q/k/v projection, softmax
attention over all frames (heads of output / heads, scaled by their
size's inverse root) plus the FSMN memory (a depthwise convolution of v
with kernel 11, centred, plus v itself), the output projection; a residual
around it except in the first block, whose width changes; then LayerNorm,
a ReLU feed-forward and its residual.  ``encoders0``, the further
``encoders``, ``after_norm``, the ``tp_encoders``, ``tp_norm``; the CTC
head is a linear layer over the last hidden state.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.precision import mm


def layer_norm(x, w, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def position_encoding(t: int, width: int, device) -> torch.Tensor:
    pos = torch.arange(1, t + 1, device=device, dtype=torch.float32)[:, None]
    step = math.log(10000.0) / (width / 2 - 1)
    inv = torch.exp(-step * torch.arange(width // 2, device=device, dtype=torch.float32))
    return torch.cat([torch.sin(pos * inv), torch.cos(pos * inv)], dim=1)


def sanm(x: torch.Tensor, w: Dict[str, torch.Tensor], p: str, heads: int) -> torch.Tensor:
    t = x.shape[0]
    y = layer_norm(x, w[p + "norm1.weight"], w[p + "norm1.bias"])
    q, k, v = (mm(y, w[p + "qkv.weight"].T) + w[p + "qkv.bias"]).chunk(3, dim=-1)
    d = v.shape[-1]
    kernel = w[p + "fsmn.weight"]                                   # [d, 1, K]
    half = (kernel.shape[-1] - 1) // 2
    vp = F.pad(v.T[None], (half, kernel.shape[-1] - 1 - half))
    memory = F.conv1d(vp, kernel, groups=d)[0].T + v
    hd = d // heads
    qh, kh, vh = (z.reshape(t, heads, hd).transpose(0, 1) for z in (q, k, v))
    att = mm(torch.softmax(mm(qh, kh.transpose(1, 2)) / math.sqrt(hd), dim=-1), vh)
    att = mm(att.transpose(0, 1).reshape(t, d), w[p + "out.weight"].T) + w[p + "out.bias"] + memory
    x = att if x.shape[-1] != d else x + att
    y = layer_norm(x, w[p + "norm2.weight"], w[p + "norm2.bias"])
    return x + mm(torch.relu(mm(y, w[p + "w1.weight"].T) + w[p + "w1.bias"]),
                  w[p + "w2.weight"].T) + w[p + "w2.bias"]


def encode(w: Dict[str, torch.Tensor], cfg: Dict, feats: torch.Tensor,
           query_ids: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hidden [4 + T, output], CTC logits [4 + T, vocab]) of one utterance's
    features [T, input]."""
    heads = cfg["attention_heads"]
    x = torch.cat([w["query_embed"][list(query_ids)], feats], dim=0)
    x = x * math.sqrt(cfg["output_size"]) + position_encoding(x.shape[0], x.shape[1], x.device)
    x = sanm(x, w, "encoders0.", heads)
    for i in range(cfg["num_blocks"] - 1):
        x = sanm(x, w, f"encoders.{i}.", heads)
    x = layer_norm(x, w["after_norm.weight"], w["after_norm.bias"])
    for i in range(cfg["tp_blocks"]):
        x = sanm(x, w, f"tp_encoders.{i}.", heads)
    x = layer_norm(x, w["tp_norm.weight"], w["tp_norm.bias"])
    return x, mm(x, w["ctc_lo.weight"].T) + w["ctc_lo.bias"]
