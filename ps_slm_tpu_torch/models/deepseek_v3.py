"""DeepSeek-V3 decoder LLM (``model_type`` ``deepseek_v3``: Moonlight-16B-A3B,
Kimi-K2, DeepSeek-V3), with the same interface as
:class:`~ps_slm_tpu_torch.models.qwen2.Qwen2Model`.

No counterpart in the JAX package, which runs Qwen2 only; the plain
reference it is held against is ``portbench/reference/deepseek_v3.py``.

* **Latent attention (MLA)**, ``q_lora_rank`` null: q is one projection to
  heads x (nope 128 + rope 64); ``kv_a_proj_with_mqa`` gives the latent
  ``c_kv`` (512, through ``kv_a_layernorm``) and one rotary key ``k_pe``
  (64) shared by all heads; ``kv_b_proj`` expands ``c_kv`` into each
  head's ``k_nope`` (128) and ``v`` (128).  Rotary embeddings in fp32, on
  DeepSeek's layout (each pair (x[2i], x[2i+1]) brought to (i, d/2 + i),
  then rotate-half); scores scaled by 192^-0.5.
* Two exact rewrites of the same attention.  Without a cache, and for a
  prefill into one, the **expanded** form: k = [k_nope, k_pe], v, through
  :func:`~ps_slm_tpu_torch.ops.attention.attention` (the flash kernel's
  q/k 192, v 128 instantiation on the card).  Cached steps after the
  prefill take the **absorbed** form over the latent cache: q_nope folded
  through ``kv_b``'s k rows into the latent space, scores q_lat . c_kv +
  q_pe . k_pe, the context taken in the latent space and then through
  ``kv_b``'s v rows.  The cache is the latent, not the heads: per layer
  ``c_kv`` [B, capacity, 512] and ``k_pe`` [B, capacity, 64] in the model's
  dtype (31 104 bytes a position over Moonlight's 27 layers in bf16, where
  expanded keys and values would take 276 480), batch on axis 0 and
  capacity on axis 1 as every cache leaf of the port.
* **Feed-forward**: the first ``first_k_dense_replace`` layers a SwiGLU;
  the rest a mixture of ``n_routed_experts`` SwiGLU experts
  (:mod:`ps_slm_tpu_torch.ops.moe`: the sigmoid router with its
  correction bias, the grouped kernels on the card) plus the shared
  experts, one SwiGLU of ``n_shared_experts`` x the expert width, added
  unweighted.
* An untied ``lm_head``.

Module names follow the HF checkpoint's within a layer (``self_attn.*``,
``mlp.gate``, ``mlp.shared_experts.*``), except that each layer's routed
experts are two stacked tensors, ``mlp.experts.gate_up_proj`` [E, 2I, H]
(gate rows first) and ``mlp.experts.down_proj`` [E, H, I];
:func:`hf_to_state_dict` stacks a checkpoint's per-expert weights.  Not
carried: int8 / int4 weights, the int8 cache, PEFT adapters, tensor and
pipeline parallelism (each refused by name); and the flash backward at
q/k 192, so training runs on the CPU only (ROADMAP queue C).

While a profiler records, eager calls open ``tasu.mla`` and ``tasu.moe``
spans; every MoE call adds its rows by expert to the device tallies
(``ops/moe.py``).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, fields
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ps_slm_tpu_torch._build import resolve_device
from ps_slm_tpu_torch.models.layers import normal_, run_block
from ps_slm_tpu_torch.models.qwen2 import (
    CacheIndex, KVCache, RMSNorm, _write_cells, read_safetensors, rope,
)
from ps_slm_tpu_torch.ops import moe
from ps_slm_tpu_torch.ops.attention import attention
from ps_slm_tpu_torch.ops.flash_attention import NEG_INF
from ps_slm_tpu_torch.utils.profiler import span

# keys of an HF config.json whose values this decoder does not implement
# (the value it takes on the right)
_REQUIRED = {"q_lora_rank": None, "scoring_func": "sigmoid", "topk_method": "noaux_tc",
             "n_group": 1, "topk_group": 1, "moe_layer_freq": 1, "hidden_act": "silu",
             "attention_bias": False, "rope_scaling": None, "ep_size": 1}


@dataclass(frozen=True)
class DeepseekV3Config:
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 8192

    @property
    def model_type(self) -> str:
        return "deepseek_v3"

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @staticmethod
    def tiny(**kw) -> "DeepseekV3Config":
        """Test widths (keys of an HF ``config.json`` over them)."""
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=96,
                    moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
                    n_routed_experts=8, n_shared_experts=2, num_experts_per_tok=3,
                    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                    rope_theta=10000.0)
        return DeepseekV3Config.from_hf({**base, **kw})

    @staticmethod
    def from_hf(config: dict) -> "DeepseekV3Config":
        """From an HF ``config.json`` dict (Moonlight's keys); raises
        ``NotImplementedError`` for a setting this decoder does not
        implement (a q low-rank projection, grouped or softmax routing,
        rope scaling, ...).  Unknown keys are ignored."""
        for key, want in _REQUIRED.items():
            if config.get(key, want) != want:
                raise NotImplementedError(
                    f"deepseek_v3: {key}={config[key]!r} is not implemented (only {want!r})")
        if config.get("model_type", "deepseek_v3") != "deepseek_v3":
            raise ValueError(f"not a deepseek_v3 config: {config['model_type']!r}")
        names = {f.name for f in fields(DeepseekV3Config)}
        return DeepseekV3Config(**{k: v for k, v in config.items() if k in names})


def rope_pairs(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """DeepSeek's rotary embedding, in fp32: x [B,S,H,d] with each pair
    (x[2i], x[2i+1]) brought to (i, d/2 + i), then rotate-half at
    ``positions`` [B,S]; output in that layout, in x's dtype."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    return rope(x, positions, theta)


class SwiGLU(nn.Module):
    def __init__(self, hidden: int, inter: int):
        super().__init__()
        self.gate_proj = nn.Linear(hidden, inter, bias=False)
        self.up_proj = nn.Linear(hidden, inter, bias=False)
        self.down_proj = nn.Linear(inter, hidden, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LatentAttention(nn.Module):
    def __init__(self, cfg: DeepseekV3Config):
        super().__init__()
        self.cfg = cfg
        h, nh = cfg.hidden_size, cfg.num_attention_heads
        self.q_proj = nn.Linear(h, nh * cfg.q_head_dim, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(h, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                                            bias=False)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = nn.Linear(cfg.kv_lora_rank,
                                   nh * (cfg.qk_nope_head_dim + cfg.v_head_dim), bias=False)
        self.o_proj = nn.Linear(nh * cfg.v_head_dim, h, bias=False)

    def forward(self, y: torch.Tensor, positions: torch.Tensor,
                attn_mask: Optional[torch.Tensor], cache: Optional[Tuple[torch.Tensor, ...]],
                cache_index: Optional[CacheIndex]) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = y.shape
        nh, dn, dr, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim)
        rank = cfg.kv_lora_rank
        q = self.q_proj(y).view(b, s, nh, dn + dr)
        q_nope = q[..., :dn]
        q_pe = rope_pairs(q[..., dn:], positions, cfg.rope_theta)
        kv_a = self.kv_a_proj_with_mqa(y)
        c_kv = self.kv_a_layernorm(kv_a[..., :rank].contiguous())
        k_pe = rope_pairs(kv_a[..., None, rank:], positions, cfg.rope_theta)[:, :, 0]
        prefill = (s > 1 and cache is not None and not torch.is_tensor(cache_index)
                   and cache_index == 0)
        if cache is not None:
            _write_cells(cache[0], c_kv, cache_index)
            _write_cells(cache[1], k_pe, cache_index)
        if cache is None or prefill:
            kv = self.kv_b_proj(c_kv).view(b, s, nh, dn + dv)
            qf = torch.cat([q_nope, q_pe], dim=-1)
            kf = torch.cat([kv[..., :dn], k_pe[:, :, None].expand(b, s, nh, dr)], dim=-1)
            mask = attn_mask if cache is None or attn_mask is None else attn_mask[:, :s]
            attn = attention(qf, kf, kv[..., dn:], kv_mask=mask, causal=True)
        else:
            attn = self._absorbed(q_nope, q_pe, cache, attn_mask, None if s == 1 else cache_index)
        return self.o_proj(attn.reshape(b, s, nh * dv))

    def _absorbed(self, q_nope, q_pe, cache, attn_mask, q_offset) -> torch.Tensor:
        """Attention over the latent cache: [B,S,H,dv] in q's dtype.  Scores
        (q_nope W_uk) . c_kv + q_pe . k_pe, an fp32 softmax over the cells
        ``attn_mask`` marks (and, for a chunk of several tokens, causally
        from ``q_offset``), the context in the latent space through
        W_uv."""
        cfg = self.cfg
        nh, dn, dv = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
        c_kv, k_pe = cache
        w = self.kv_b_proj.weight.view(nh, dn + dv, cfg.kv_lora_rank)
        q_lat = torch.einsum("bshd,hdc->bshc", q_nope, w[:, :dn])
        scores = (torch.einsum("bshc,btc->bhst", q_lat, c_kv)
                  + torch.einsum("bshr,btr->bhst", q_pe, k_pe)).float()
        scores = scores * cfg.q_head_dim ** -0.5
        t = c_kv.shape[1]
        mask = attn_mask[:, None, None, :]
        if q_offset is not None:
            s = q_nope.shape[1]
            q_pos = torch.arange(s, device=scores.device)[None, :, None] + torch.as_tensor(
                q_offset, device=scores.device).reshape(-1, 1, 1)
            mask = mask & (torch.arange(t, device=scores.device)[None, None, :] <= q_pos)[:, None]
        probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
        probs = torch.where(mask, probs, 0.0).to(c_kv.dtype)
        ctx = torch.einsum("bhst,btc->bshc", probs, c_kv)
        return torch.einsum("bshc,hdc->bshd", ctx, w[:, dn:])


class MoE(nn.Module):
    """The routed experts (stacked) and the shared experts of one layer."""

    def __init__(self, cfg: DeepseekV3Config, layer: int):
        super().__init__()
        self.cfg, self.layer = cfg, layer
        h, e, i = cfg.hidden_size, cfg.n_routed_experts, cfg.moe_intermediate_size
        self.gate = nn.Linear(h, e, bias=False)
        self.gate.register_parameter("e_score_correction_bias", nn.Parameter(torch.empty(e)))
        self.experts = nn.Module()
        self.experts.gate_up_proj = nn.Parameter(torch.empty(e, 2 * i, h))
        self.experts.down_proj = nn.Parameter(torch.empty(e, h, i))
        self.shared_experts = SwiGLU(h, i * cfg.n_shared_experts)
        # each call's chosen experts [T, k] are appended here when it is a list
        self.routes: Optional[List[torch.Tensor]] = None
        self.top_k = cfg.num_experts_per_tok

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, h = y.shape
        x = y.reshape(b * s, h)
        idx, w = moe.route(x, self.gate.weight, self.gate.e_score_correction_bias, self.top_k,
                           cfg.routed_scaling_factor, cfg.norm_topk_prob)
        if self.routes is not None:
            self.routes.append(idx)
        counts = moe.record(idx, cfg.n_routed_experts, self.layer, cfg.num_hidden_layers,
                            step=s == 1)
        out = moe.experts(x, idx, w, self.experts.gate_up_proj, self.experts.down_proj, counts)
        return out.view(b, s, h) + self.shared_experts(y)


class DeepseekV3Block(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, layer: int):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LatentAttention(cfg)
        self.mlp = (SwiGLU(cfg.hidden_size, cfg.intermediate_size)
                    if layer < cfg.first_k_dense_replace else MoE(cfg, layer))

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                attn_mask: Optional[torch.Tensor], cache=None,
                cache_index: Optional[CacheIndex] = None, lora_keep=None,
                lora_rate: float = 0.0) -> torch.Tensor:
        with span("mla"):
            x = x + self.self_attn(self.input_layernorm(x), positions, attn_mask, cache,
                                   cache_index)
        y = self.post_attention_layernorm(x)
        if isinstance(self.mlp, MoE):
            with span("moe"):
                return x + self.mlp(y)
        return x + self.mlp(y)


class DeepseekV3Model(nn.Module):
    def __init__(self, cfg: DeepseekV3Config):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DeepseekV3Block(cfg, i) for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        self.remat = False
        self.lora_dropout = 0.0
        self.mesh = None
        self.pp_microbatches = 0
        self.vocab = None

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def unembed(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden -> fp32 vocab logits (matmul in the compute dtype)."""
        return F.linear(hidden, self.lm_head.weight.to(hidden.dtype)).float()

    def forward(self, inputs_embeds: torch.Tensor, attention_mask: Optional[torch.Tensor],
                position_ids: torch.Tensor, cache: Optional[KVCache] = None,
                cache_index: Optional[CacheIndex] = None, *,
                generator: Optional[torch.Generator] = None,
                lora_masks=None) -> Tuple[torch.Tensor, Optional[KVCache]]:
        """The decoder stack: (last hidden after the final norm, cache), as
        :meth:`Qwen2Model.forward` (masks and positions alike); with
        ``remat`` and no cache, while gradients are recorded, each block is
        recomputed in the backward."""
        if self.mesh is not None:
            raise NotImplementedError("deepseek_v3 runs on one device (no mesh)")
        if lora_masks is not None:
            raise NotImplementedError("deepseek_v3 carries no PEFT adapters")
        remat = self.remat and cache is None and torch.is_grad_enabled()
        x = inputs_embeds
        for i, layer in enumerate(self.layers):
            x = run_block(layer, remat, x, position_ids, attention_mask,
                          None if cache is None else cache[i], cache_index)
        return self.norm(x), cache

    def init_cache(self, batch: int, capacity: int, dtype: torch.dtype, device="cuda",
                   kv_bits: int = 16) -> KVCache:
        """Zeroed latent caches, per layer (c_kv [batch, capacity, 512],
        k_pe [batch, capacity, 64]) in ``dtype``."""
        if kv_bits != 16:
            raise NotImplementedError(
                f"deepseek_v3: no int{kv_bits} latent cache (kv_bits=16 only; ROADMAP queue C)")
        dev = resolve_device(device)
        cfg = self.cfg
        return [(torch.zeros(batch, capacity, cfg.kv_lora_rank, dtype=dtype, device=dev),
                 torch.zeros(batch, capacity, cfg.qk_rope_head_dim, dtype=dtype, device=dev))
                for _ in range(cfg.num_hidden_layers)]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Linear weights N(0, 1 / in), norms 1, the correction bias 0."""
        for name, p in self.named_parameters():
            if name.endswith(("layernorm.weight", "norm.weight", "e_score_correction_bias")):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            else:
                normal_(p, 1.0 / math.sqrt(p.shape[-1]), generator)

    def set_routes(self, routes: Optional[List[torch.Tensor]]) -> None:
        """Record each MoE layer's chosen experts into ``routes`` (a list, in
        layer order a forward), or stop (None)."""
        for layer in self.layers:
            if isinstance(layer.mlp, MoE):
                layer.mlp.routes = routes


# ----------------------------------------------------------------------------
# HF checkpoints
# ----------------------------------------------------------------------------

def hf_to_state_dict(tensors: Dict[str, torch.Tensor], cfg: DeepseekV3Config
                     ) -> Dict[str, torch.Tensor]:
    """An HF DeepSeek-V3 state dict (names with or without ``model.``) ->
    a :class:`DeepseekV3Model` state dict: the same names within a layer,
    each layer's per-expert weights stacked.  Raises ``KeyError`` on a
    missing tensor."""
    def get(name):
        for cand in (name, f"model.{name}"):
            if cand in tensors:
                return tensors[cand]
        raise KeyError(name)

    out = {"embed_tokens.weight": get("embed_tokens.weight"), "norm.weight": get("norm.weight"),
           "lm_head.weight": get("lm_head.weight")}
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        names = ["input_layernorm.weight", "post_attention_layernorm.weight"] + [
            f"self_attn.{n}.weight" for n in ("q_proj", "kv_a_proj_with_mqa", "kv_a_layernorm",
                                              "kv_b_proj", "o_proj")]
        if i < cfg.first_k_dense_replace:
            names += [f"mlp.{n}.weight" for n in ("gate_proj", "up_proj", "down_proj")]
        else:
            names += ["mlp.gate.weight", "mlp.gate.e_score_correction_bias"] + [
                f"mlp.shared_experts.{n}.weight" for n in ("gate_proj", "up_proj", "down_proj")]
            ex = [f"{p}mlp.experts.{e}." for e in range(cfg.n_routed_experts)]
            out[p + "mlp.experts.gate_up_proj"] = torch.stack(
                [torch.cat([get(e + "gate_proj.weight"), get(e + "up_proj.weight")]) for e in ex])
            out[p + "mlp.experts.down_proj"] = torch.stack(
                [get(e + "down_proj.weight") for e in ex])
        for n in names:
            out[p + n] = get(p + n)
    return out


def state_dict_to_hf(llm: DeepseekV3Model) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`hf_to_state_dict`: ``model.``-prefixed HF names,
    the stacked experts split per expert, ``lm_head.weight``."""
    cfg, out = llm.cfg, {}
    inter = cfg.moe_intermediate_size
    for name, t in llm.state_dict().items():
        if name == "lm_head.weight":
            out[name] = t
        elif name.endswith("mlp.experts.gate_up_proj"):
            base = "model." + name[: -len("gate_up_proj")]
            for e in range(t.shape[0]):
                out[f"{base}{e}.gate_proj.weight"] = t[e, :inter]
                out[f"{base}{e}.up_proj.weight"] = t[e, inter:]
        elif name.endswith("mlp.experts.down_proj"):
            base = "model." + name[: -len("down_proj")]
            for e in range(t.shape[0]):
                out[f"{base}{e}.down_proj.weight"] = t[e]
        else:
            out["model." + name] = t
    return out


def load_hf_checkpoint(path: str, cfg: Optional[DeepseekV3Config] = None
                       ) -> Tuple[Dict[str, torch.Tensor], DeepseekV3Config]:
    """(state dict, config) of an HF DeepSeek-V3 directory: ``config.json``
    (unless ``cfg`` is given) and every ``*.safetensors`` file, tensors in
    the file's dtype on the CPU."""
    if cfg is None:
        with open(os.path.join(path, "config.json")) as f:
            cfg = DeepseekV3Config.from_hf(json.load(f))
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {path}")
    tensors: Dict[str, torch.Tensor] = {}
    for fname in files:
        tensors.update(read_safetensors(os.path.join(path, fname)))
    return hf_to_state_dict(tensors, cfg), cfg
