"""Qwen2/Qwen2.5 decoder LLM.

Counterpart of ``ps_slm_tpu/models/qwen2.py``: RMSNorm (fp32 statistics,
the CUDA kernels on CUDA tensors), rotate-half rotary embeddings in fp32,
GQA attention with q/k/v biases, SwiGLU MLP, tied or untied LM head.  One
module per layer.  The KV cache is a list of per-layer (k, v) tensors
[B, capacity, Hkv, D] that :meth:`Qwen2Model.forward` updates in place
(the JAX package returns new arrays; writing in place keeps one copy).

Not ported yet: LoRA, prefix tuning, llama-adapter and the int8/int4
weights and int8 KV cache (ROADMAP.md queue 1, "PEFT and quantization").
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ps_slm_tpu_torch._build import resolve_device
from ps_slm_tpu_torch.models.layers import normal_
from ps_slm_tpu_torch.ops.attention import attention, decode_attention
from ps_slm_tpu_torch.ops.norms import RMSNormFn

KVCache = List[Tuple[torch.Tensor, torch.Tensor]]


@dataclass(frozen=True)
class Qwen2Config:
    vocab_size: int = 151936
    hidden_size: int = 1536
    intermediate_size: int = 8960
    num_hidden_layers: int = 28
    num_attention_heads: int = 12
    num_key_value_heads: int = 2
    head_dim: int = 128
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 32768
    attention_bias: bool = True   # Qwen2 has biases on q/k/v

    @staticmethod
    def tiny(**kw) -> "Qwen2Config":
        base = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, rope_theta=10000.0,
        )
        base.update(kw)
        return Qwen2Config(**base)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with fp32 statistics, output in x.dtype; the CUDA kernels,
    forward and backward, on CUDA tensors."""
    return RMSNormFn.apply(x, weight, eps)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding in fp32.  x [B,S,H,D]; positions [B,S]."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d))
    angles = positions[..., None].float() * freqs              # [B,S,D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class Qwen2Block(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.cfg = cfg
        h, i = cfg.hidden_size, cfg.intermediate_size
        nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        self.input_layernorm = RMSNorm(h, cfg.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(h, cfg.rms_norm_eps)
        self.q_proj = nn.Linear(h, nh * hd, bias=cfg.attention_bias)
        self.k_proj = nn.Linear(h, nkv * hd, bias=cfg.attention_bias)
        self.v_proj = nn.Linear(h, nkv * hd, bias=cfg.attention_bias)
        self.o_proj = nn.Linear(nh * hd, h, bias=False)
        self.gate_proj = nn.Linear(h, i, bias=False)
        self.up_proj = nn.Linear(h, i, bias=False)
        self.down_proj = nn.Linear(i, h, bias=False)

    def forward(
        self, x: torch.Tensor, positions: torch.Tensor,
        attn_mask: Optional[torch.Tensor],
        cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        cache_index: Optional[int] = None,
    ) -> torch.Tensor:
        """One block.  Without a cache: causal attention over x's own
        positions.  With a cache: k/v are written at ``cache_index``; a
        prefill (``cache_index`` 0, S > 1) attends over its own k/v through
        the flash kernel, a one-token step over the cache (plain)."""
        cfg = self.cfg
        b, s, _ = x.shape
        nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        y = self.input_layernorm(x)
        q = rope(self.q_proj(y).view(b, s, nh, hd), positions, cfg.rope_theta)
        k = rope(self.k_proj(y).view(b, s, nkv, hd), positions, cfg.rope_theta)
        v = self.v_proj(y).view(b, s, nkv, hd)

        if cache_kv is None:
            attn = attention(q, k, v, kv_mask=attn_mask, causal=True)
        else:
            k_cache, v_cache = cache_kv
            k_cache[:, cache_index:cache_index + s] = k
            v_cache[:, cache_index:cache_index + s] = v
            if s == 1:
                attn = decode_attention(q, k_cache, v_cache, attn_mask)
            elif cache_index == 0:
                attn = attention(q, k, v, kv_mask=attn_mask[:, :s], causal=True)
            else:
                raise NotImplementedError(
                    "multi-token chunks after the prefill (speculative "
                    "windows) are not ported yet (ROADMAP.md queue 1, 'Serving')"
                )

        x = x + self.o_proj(attn.reshape(b, s, nh * hd))
        y = self.post_attention_layernorm(x)
        return x + self.down_proj(F.silu(self.gate_proj(y)) * self.up_proj(y))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.input_layernorm.weight.fill_(1.0)
        self.post_attention_layernorm.weight.fill_(1.0)
        for lin in (self.q_proj, self.k_proj, self.v_proj, self.o_proj,
                    self.gate_proj, self.up_proj, self.down_proj):
            normal_(lin.weight, 1.0 / math.sqrt(lin.in_features), generator)
            if lin.bias is not None:
                lin.bias.zero_()


class Qwen2Model(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(Qwen2Block(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = (
            None if cfg.tie_word_embeddings
            else nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        )

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def unembed(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden -> fp32 vocab logits (matmul in the compute dtype)."""
        w = self.embed_tokens.weight if self.lm_head is None else self.lm_head.weight
        return F.linear(hidden, w.to(hidden.dtype)).float()

    def forward(
        self, inputs_embeds: torch.Tensor,
        attention_mask: Optional[torch.Tensor],
        position_ids: torch.Tensor,
        cache: Optional[KVCache] = None,
        cache_index: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Optional[KVCache]]:
        """Run the decoder stack: (last hidden after the final norm, cache).

        attention_mask: [B,S] without a cache, [B,capacity] with one.
        position_ids: [B,S] (the merge's, or the next positions in decode).
        """
        x = inputs_embeds
        for i, layer in enumerate(self.layers):
            x = layer(
                x, position_ids, attention_mask,
                None if cache is None else cache[i], cache_index,
            )
        return self.norm(x), cache

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        h = self.cfg.hidden_size
        for layer in self.layers:
            layer.init_weights(generator)
        normal_(self.embed_tokens.weight, 1.0 / math.sqrt(h), generator)
        self.norm.weight.fill_(1.0)
        if self.lm_head is not None:
            normal_(self.lm_head.weight, 1.0 / math.sqrt(h), generator)


def init_cache(
    cfg: Qwen2Config, batch: int, capacity: int, dtype: torch.dtype, device="cuda",
) -> KVCache:
    """Zeroed per-layer (k, v) caches [batch, capacity, Hkv, D] in ``dtype``
    (the int8 cache waits for ROADMAP.md queue 1, 'PEFT and quantization')."""
    dev = resolve_device(device)
    shape = (batch, capacity, cfg.num_key_value_heads, cfg.head_dim)
    return [
        (torch.zeros(shape, dtype=dtype, device=dev), torch.zeros(shape, dtype=dtype, device=dev))
        for _ in range(cfg.num_hidden_layers)
    ]
