"""Qwen2/Qwen2.5 decoder LLM.

Counterpart of ``ps_slm_tpu/models/qwen2.py``: RMSNorm (fp32 statistics,
the CUDA kernels on CUDA tensors), rotate-half rotary embeddings in fp32,
GQA attention with q/k/v biases, SwiGLU MLP, tied or untied LM head.  One
module per layer.  The KV cache is a list of per-layer tuples that
:meth:`Qwen2Model.forward` updates in place (the JAX package returns new
arrays; writing in place keeps one copy): (k, v) [B, capacity, Hkv, D] in
the model's dtype, or with ``kv_bits=8`` (k8, kscale, v8, vscale), int8
cells and one fp32 scale per [D] vector, quantized at write and
dequantized at read.  Every cache leaf has the batch on axis 0 and the
capacity on axis 1.  A chunk is written at ``cache_index``, an int or a
[B] tensor of per-row offsets (the slot pools).

The projections may be :class:`QuantLinear` (int8 or group-wise int4
weights, :func:`ps_slm_tpu_torch.models.quantization.quantize_llm`).  The
PEFT adapters (:mod:`ps_slm_tpu_torch.models.lora`) act inside the block
as in the JAX ``_block``: LoRA adds ``((x @ A) @ B) * scale`` to its
projection (the input under the training step's dropout masks); a prefix
(prefix tuning) is prepended, un-rotated, to the keys and values every
query attends over, in the plain ``mha_reference`` as the JAX forward
takes it, and is never written to the KV cache; llama-adapter adds a gated
attention over the layer's own projections of its prompt before
``o_proj``.

Under tensor parallelism (``parallel/mesh.py`` sets ``Qwen2Block.tp`` and
``Qwen2Model.vocab``, ``parallel.tensor.Shards``) a block holds its heads'
columns of q/k/v/gate/up and rows of o/down, and sums o's and down's
partial outputs and its inputs' gradients over the ranks
(``parallel.tensor``); the embedding table (and an untied ``lm_head``) is
sharded on its vocabulary rows.  The adapters stay whole on every rank:
LoRA acts on its rank's block of each base, the prefix and llama-adapter
on its KV heads.

Checkpoints: :func:`load_hf_checkpoint` reads an HF Qwen2 directory
(``config.json`` + ``*.safetensors``) into a state dict of this module's
names, with the port's own safetensors reader (:func:`read_safetensors`:
no ``safetensors`` package needed); :func:`state_dict_to_hf` inverts the
names for the reference-checkpoint exporter.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ps_slm_tpu_torch._build import resolve_device
from ps_slm_tpu_torch.models.layers import normal_, run_block
from ps_slm_tpu_torch.models.lora import lora_delta, lora_dropout_masks
from ps_slm_tpu_torch.models.quantization import (
    _group_size, dequantize_kernel, dequantize_kernel4, dequantize_kv, q4_matmul, q8_matmul,
    quantize_kernel, quantize_kernel4, quantize_kv,
)
from ps_slm_tpu_torch.ops.attention import attention, decode_attention, mha_reference
from ps_slm_tpu_torch.ops.norms import RMSNormFn
from ps_slm_tpu_torch.parallel.tensor import copy_in, gather_last, reduce_out, vocab_embed

KVCache = List[Tuple[torch.Tensor, ...]]
# the row-parallel projections under tensor parallelism (the rest: column)
ROW_PARALLEL = ("o_proj", "down_proj")
CacheIndex = Union[int, torch.Tensor]


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

    @staticmethod
    def from_hf(config: dict) -> "Qwen2Config":
        """Build from an HF ``config.json`` dict (``tie_word_embeddings``
        False where the file does not say, as HF's default)."""
        hd = config.get("head_dim") or (
            config["hidden_size"] // config["num_attention_heads"]
        )
        return Qwen2Config(
            vocab_size=config["vocab_size"],
            hidden_size=config["hidden_size"],
            intermediate_size=config["intermediate_size"],
            num_hidden_layers=config["num_hidden_layers"],
            num_attention_heads=config["num_attention_heads"],
            num_key_value_heads=config["num_key_value_heads"],
            head_dim=hd,
            rope_theta=config.get("rope_theta", 1e6),
            rms_norm_eps=config.get("rms_norm_eps", 1e-6),
            tie_word_embeddings=config.get("tie_word_embeddings", False),
            max_position_embeddings=config.get("max_position_embeddings", 32768),
        )


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


class QuantLinear(nn.Module):
    """A projection with weight-only int8 or group-wise int4 weights: the
    codes (``q8`` or ``q4``, int8 [in, out], the JAX layout) and their fp32
    scales (``scale`` [out] or ``scale4`` [in / gs, out]) are buffers with
    no gradient; the bias stays a parameter in the model's dtype.  Computes
    what the JAX ``_linear`` computes: the quantized product in x's dtype
    (:func:`~ps_slm_tpu_torch.models.quantization.q8_matmul`, ``q4_matmul``),
    then the bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool, bits: int = 8,
                 group_size: int = 128, *, dtype=torch.float32, device=None):
        super().__init__()
        if bits not in (4, 8):
            raise ValueError(f"quant_bits must be 4 or 8, got {bits}")
        self.in_features, self.out_features, self.bits = in_features, out_features, bits
        codes = torch.zeros(in_features, out_features, dtype=torch.int8, device=device)
        if bits == 8:
            self.register_buffer("q8", codes)
            self.register_buffer("scale", torch.ones(out_features, device=device))
        else:
            groups = in_features // _group_size(in_features, group_size)
            self.register_buffer("q4", codes)
            self.register_buffer("scale4", torch.ones(groups, out_features, device=device))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_features, dtype=dtype, device=device))
        else:
            self.register_parameter("bias", None)

    def _node(self) -> Dict[str, torch.Tensor]:
        names = ("q8", "scale") if self.bits == 8 else ("q4", "scale4")
        return {n: getattr(self, n) for n in names}

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear, bits: int, group_size: int = 128) -> "QuantLinear":
        """Quantize ``lin``'s weight as it stands in its dtype; the bias
        parameter is kept."""
        w = lin.weight.T                                       # [in, out]
        m = cls(lin.in_features, lin.out_features, False, bits, group_size,
                dtype=w.dtype, device=w.device)
        node = quantize_kernel(w) if bits == 8 else quantize_kernel4(w, group_size)
        for name, value in node.items():
            getattr(m, name).copy_(value)
        m.bias = lin.bias
        return m

    @torch.no_grad()
    def to_linear(self, dtype) -> nn.Linear:
        """An ``nn.Linear`` holding the dequantized kernel in ``dtype``."""
        node = self._node()
        w = dequantize_kernel(node, dtype) if self.bits == 8 else dequantize_kernel4(node, dtype)
        lin = nn.Linear(self.in_features, self.out_features, bias=self.bias is not None,
                        dtype=dtype, device=w.device)
        lin.weight.copy_(w.T)
        if self.bias is not None:
            lin.bias.copy_(self.bias)
        return lin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bits == 8:
            y = q8_matmul(x, self.q8, self.scale)
        else:
            y = q4_matmul(x, self.q4, self.scale4)
        return y if self.bias is None else y + self.bias


def _write_cells(leaf: torch.Tensor, value: torch.Tensor, cache_index: CacheIndex) -> None:
    """Write a chunk [B, S, ...] into a cache leaf at ``cache_index`` (an int,
    or a [B] tensor of per-row offsets).  Every caller keeps its writes
    inside the capacity (the cache is sized for it), so no write is dropped."""
    s = value.shape[1]
    if torch.is_tensor(cache_index) and cache_index.dim() == 1:
        rows = torch.arange(leaf.shape[0], device=leaf.device)[:, None]
        cols = cache_index[:, None] + torch.arange(s, device=leaf.device)
        leaf[rows, cols] = value.to(leaf.dtype)
    else:
        leaf[:, cache_index:cache_index + s] = value.to(leaf.dtype)


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
        # PEFT (models/lora.py): set by add_prefix_tuning / add_llama_adapter
        for name in ("prefix_k", "prefix_v", "adaption_prompt", "adaption_gate"):
            self.register_parameter(name, None)
        self.register_buffer("adaption_mask", None)
        # this rank's place in a tensor-parallel group (parallel/mesh.py)
        self.tp = None

    def _proj(self, name: str, x: torch.Tensor, keep: Optional[Dict[str, torch.Tensor]] = None,
              rate: float = 0.0) -> torch.Tensor:
        """Projection ``name`` of x, plus its LoRA (x under ``keep[name]``,
        the dropout mask, when given).  Under ``tp`` a column-parallel
        projection gives this rank's columns and a row-parallel one (x its
        rows) the sum over the ranks, its LoRA added before the sum."""
        lin = getattr(self, name)
        y = lin(x)
        part = None
        if self.tp is not None:
            w = lin.weight
            part = (("row", self.tp.block(w.shape[1] * self.tp.size)) if name in ROW_PARALLEL
                    else ("col", self.tp.block(w.shape[0] * self.tp.size)))
        delta = lora_delta(lin, x, None if keep is None else keep.get(name), rate, part)
        y = y if delta is None else y + delta
        if part is not None and part[0] == "row":
            y = reduce_out(y, self.tp)
        return y

    def _kv_heads(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's KV heads of a whole-heads adapter tensor [P, Hkv, D]."""
        return t if self.tp is None else t[:, self.tp.block(t.shape[1])]

    def _with_prefix(self, k, v, mask, offset):
        """The learned prefix prepended to keys, values and mask; the causal
        offset moves by its length P (every key position shifts by P)."""
        b, n_pre = k.shape[0], self.prefix_k.shape[0]
        pk = self._kv_heads(self.prefix_k).to(k.dtype)[None].expand(b, -1, -1, -1)
        pv = self._kv_heads(self.prefix_v).to(v.dtype)[None].expand(b, -1, -1, -1)
        if mask is not None:
            mask = torch.cat([torch.ones(b, n_pre, dtype=mask.dtype, device=mask.device),
                              mask], dim=1)
        return torch.cat([pk, k], dim=1), torch.cat([pv, v], dim=1), mask, offset + n_pre

    def _adaption_attention(self, q: torch.Tensor) -> torch.Tensor:
        """llama-adapter's zero-init attention: the prompt's keys and values
        from the layer's own k/v projections (no norm, no rotation), a
        separate fp32 softmax over its P positions scaled by gate * mask,
        its context in q's layout (added before ``o_proj``)."""
        b, s, nh, hd = q.shape
        prompt = self.adaption_prompt.to(q.dtype)
        ak = self._proj("k_proj", prompt)
        nkv = ak.shape[-1] // hd                        # this rank's KV heads
        ak = ak.view(-1, nkv, hd)
        av = self._proj("v_proj", prompt).view(-1, nkv, hd)
        qg = q.reshape(b, s, nkv, nh // nkv, hd)
        scores = torch.einsum("bskrd,pkd->bskrp", qg, ak).float()
        probs = torch.softmax(scores * hd ** -0.5, dim=-1)
        gate = (self.adaption_gate * self.adaption_mask).float()
        ctx = torch.einsum("bskrp,pkd->bskrd", (gate * probs).to(q.dtype), av.to(q.dtype))
        return ctx.reshape(b, s, nh, hd)

    def forward(
        self, x: torch.Tensor, positions: torch.Tensor,
        attn_mask: Optional[torch.Tensor],
        cache_kv: Optional[Tuple[torch.Tensor, ...]] = None,
        cache_index: Optional[CacheIndex] = None,
        lora_keep: Optional[Dict[str, torch.Tensor]] = None,
        lora_rate: float = 0.0,
    ) -> torch.Tensor:
        """One block.  Without a cache: causal attention over x's own
        positions.  With a cache: k/v are written at ``cache_index`` (int8
        cells quantized at write); a prefill (``cache_index`` the int 0,
        S > 1) attends over its own S cells through the flash kernel (the
        int8 cache: their dequantized values, as the JAX prefill reads them
        back), a one-token step over the cache (plain), and a chunk of more
        tokens after the prefill (speculative windows) over the cache,
        causally from ``cache_index`` (plain, as the JAX package).  With a
        prefix every one of these attends through the plain
        ``mha_reference`` over the prefix and the whole cache, as in JAX.
        ``lora_keep`` holds the LoRA inputs' dropout masks (rate
        ``lora_rate``), drawn by the caller."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        proj = lambda name, t: self._proj(name, t, lora_keep, lora_rate)  # noqa: E731
        y = self.input_layernorm(x)
        if self.tp is not None:
            y = copy_in(y, self.tp)
        # the heads this process holds: all of them, or its share under
        # tensor parallelism (column-parallel q/k/v give local heads)
        q, k, v = proj("q_proj", y), proj("k_proj", y), proj("v_proj", y)
        nh, nkv = q.shape[-1] // hd, k.shape[-1] // hd
        q = rope(q.view(b, s, nh, hd), positions, cfg.rope_theta)
        k = rope(k.view(b, s, nkv, hd), positions, cfg.rope_theta)
        v = v.view(b, s, nkv, hd)
        has_prefix = self.prefix_k is not None

        if cache_kv is None and has_prefix:
            k_att, v_att, m_att, off = self._with_prefix(k, v, attn_mask, 0)
            attn = mha_reference(q, k_att, v_att, kv_mask=m_att, causal=True, q_offset=off)
        elif cache_kv is None:
            attn = attention(q, k, v, kv_mask=attn_mask, causal=True)
        else:
            prefill = (s > 1 and not torch.is_tensor(cache_index) and cache_index == 0
                       and not has_prefix)
            if len(cache_kv) == 4:
                k8, kscale, v8, vscale = cache_kv
                for leaf, value in zip(cache_kv, (*quantize_kv(k), *quantize_kv(v))):
                    _write_cells(leaf, value, cache_index)
                cells = slice(0, s) if prefill else slice(None)
                k_cache = dequantize_kv(k8[:, cells], kscale[:, cells], q.dtype)
                v_cache = dequantize_kv(v8[:, cells], vscale[:, cells], q.dtype)
            else:
                k_cache, v_cache = cache_kv
                _write_cells(k_cache, k, cache_index)
                _write_cells(v_cache, v, cache_index)
                if prefill:
                    k_cache, v_cache = k, v
            if has_prefix:
                k_att, v_att, m_att, off = self._with_prefix(k_cache, v_cache, attn_mask,
                                                             cache_index)
                attn = mha_reference(q, k_att, v_att, kv_mask=m_att, causal=True,
                                     q_offset=off)
            elif s == 1:
                attn = decode_attention(q, k_cache, v_cache, attn_mask)
            elif prefill:
                attn = attention(q, k_cache, v_cache, kv_mask=attn_mask[:, :s], causal=True)
            else:
                attn = mha_reference(q, k_cache, v_cache, kv_mask=attn_mask, causal=True,
                                     q_offset=cache_index)

        if self.adaption_prompt is not None:
            attn = attn + self._adaption_attention(q)
        x = x + proj("o_proj", attn.reshape(b, s, nh * hd))
        y = self.post_attention_layernorm(x)
        if self.tp is not None:
            y = copy_in(y, self.tp)
        return x + proj("down_proj", F.silu(proj("gate_proj", y)) * proj("up_proj", y))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.input_layernorm.weight.fill_(1.0)
        self.post_attention_layernorm.weight.fill_(1.0)
        for lin in (self.q_proj, self.k_proj, self.v_proj, self.o_proj,
                    self.gate_proj, self.up_proj, self.down_proj):
            if not isinstance(lin, nn.Linear):
                raise TypeError("init_weights draws dense weights; quantize after it")
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
        # activation checkpointing of each block while gradients are recorded
        self.remat = False
        # LoRA's training dropout rate (peft_config.lora_dropout under PEFT)
        self.lora_dropout = 0.0
        # the process's place on a mesh (parallel/mesh.py) and the GPipe
        # microbatch count of a pipe axis (0: twice the stages)
        self.mesh = None
        self.pp_microbatches = 0
        # the tensor-parallel group whose ranks hold the vocabulary's row
        # blocks of the table and lm_head (parallel/mesh.py), or None
        self.vocab = None

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        if self.vocab is not None:
            return vocab_embed(self.embed_tokens.weight, input_ids, self.vocab)
        return self.embed_tokens(input_ids)

    def unembed(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden -> fp32 vocab logits (matmul in the compute dtype); with a
        sharded vocabulary each rank's block gathered (no gradient)."""
        w = self.embed_tokens.weight if self.lm_head is None else self.lm_head.weight
        logits = F.linear(hidden, w.to(hidden.dtype)).float()
        return logits if self.vocab is None else gather_last(logits, self.vocab)

    def forward(
        self, inputs_embeds: torch.Tensor,
        attention_mask: Optional[torch.Tensor],
        position_ids: torch.Tensor,
        cache: Optional[KVCache] = None,
        cache_index: Optional[CacheIndex] = None,
        *, generator: Optional[torch.Generator] = None,
        lora_masks: Optional[List[Dict[str, torch.Tensor]]] = None,
    ) -> Tuple[torch.Tensor, Optional[KVCache]]:
        """Run the decoder stack: (last hidden after the final norm, cache).
        With ``remat`` and no cache, while gradients are recorded, each block
        is recomputed in the backward (:func:`run_block`).

        attention_mask: [B,S] without a cache, [B,capacity] with one.
        position_ids: [B,S] (the merge's, or the next positions in decode).
        generator / lora_masks: LoRA dropout (``lora_dropout`` > 0, training
        only, no cache): each layer's keep masks, ``lora_masks[i]`` when
        given (tests feed the JAX step's), else drawn from ``generator``
        layer by layer before the block runs, so remat recomputes with the
        same masks.  Neither given: no dropout (eval).

        Under a mesh (``self.mesh``) the masks are this process's rows of
        the global batch's, and with a ``pipe`` axis and no cache the stack
        runs as a GPipe pipeline (:func:`~ps_slm_tpu_torch.parallel.pipeline.pipeline_apply`,
        ``pp_microbatches`` microbatches).
        """
        x = inputs_embeds
        remat = self.remat and cache is None and torch.is_grad_enabled()
        rate = self.lora_dropout if cache is None else 0.0
        drop = rate > 0.0 and (generator is not None or lora_masks is not None)
        rows = None if self.mesh is None else self.mesh.row_block
        if cache is None and self.mesh is not None and self.mesh.shape["pipe"] > 1:
            from ps_slm_tpu_torch.parallel.pipeline import pipeline_apply

            x = pipeline_apply(self, x, position_ids, attention_mask,
                               generator=generator if drop else None,
                               lora_masks=lora_masks if drop else None, rate=rate if drop else 0.0)
            return self.norm(x), cache
        for i, layer in enumerate(self.layers):
            keep = None
            if drop:
                keep = (lora_masks[i] if lora_masks is not None
                        else lora_dropout_masks(layer, x.shape, rate, generator, x.device, rows))
            x = run_block(layer, remat, x, position_ids, attention_mask,
                          None if cache is None else cache[i], cache_index, keep, rate)
        return self.norm(x), cache

    def init_cache(self, batch: int, capacity: int, dtype: torch.dtype, device="cuda",
                   kv_bits: int = 16) -> KVCache:
        """This decoder's zeroed KV cache (:func:`init_cache`)."""
        return init_cache(self.cfg, batch, capacity, dtype, device, kv_bits)

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
    kv_bits: int = 16,
) -> KVCache:
    """Zeroed per-layer caches: (k, v) [batch, capacity, Hkv, D] in ``dtype``,
    or with ``kv_bits=8`` (k8, kscale, v8, vscale), int8 cells and fp32
    scales [batch, capacity, Hkv]."""
    dev = resolve_device(device)
    shape = (batch, capacity, cfg.num_key_value_heads, cfg.head_dim)
    if kv_bits == 8:
        def layer():
            cells = torch.zeros(shape, dtype=torch.int8, device=dev)
            scales = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
            return (cells, scales, torch.zeros_like(cells), torch.zeros_like(scales))
    elif kv_bits == 16:
        def layer():
            return (torch.zeros(shape, dtype=dtype, device=dev),
                    torch.zeros(shape, dtype=dtype, device=dev))
    else:
        raise ValueError(f"kv_bits must be 8 or 16, got {kv_bits}")
    return [layer() for _ in range(cfg.num_hidden_layers)]


# ----------------------------------------------------------------------------
# HF checkpoints
# ----------------------------------------------------------------------------

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, as CPU tensors.

    The format: an 8-byte little-endian header length n, n bytes of JSON
    ``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}`` (and
    an optional ``"__metadata__"``), then the raw little-endian data, each
    tensor's offsets counted from the end of the header.  Each tensor is
    read into its own buffer, so its alignment never depends on its offset.
    """
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors data is little-endian; this host is not")
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = _ST_DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: {name} has unsupported dtype {info['dtype']}")
            begin, end = info["data_offsets"]
            buf = torch.empty(end - begin, dtype=torch.uint8)
            f.seek(base + begin)
            if f.readinto(buf.numpy()) != end - begin:
                raise ValueError(f"{path}: {name} is truncated")
            out[name] = buf.view(dtype).reshape(info["shape"])
    return out


_HF_LAYER_KEYS = {
    # HF name within model.layers.{i} -> this module's name within layers.{i}
    "input_layernorm.weight": "input_layernorm.weight",
    "post_attention_layernorm.weight": "post_attention_layernorm.weight",
    "self_attn.q_proj.weight": "q_proj.weight",
    "self_attn.k_proj.weight": "k_proj.weight",
    "self_attn.v_proj.weight": "v_proj.weight",
    "self_attn.o_proj.weight": "o_proj.weight",
    "self_attn.q_proj.bias": "q_proj.bias",
    "self_attn.k_proj.bias": "k_proj.bias",
    "self_attn.v_proj.bias": "v_proj.bias",
    "mlp.gate_proj.weight": "gate_proj.weight",
    "mlp.up_proj.weight": "up_proj.weight",
    "mlp.down_proj.weight": "down_proj.weight",
}


def hf_to_state_dict(
    tensors: Dict[str, torch.Tensor], cfg: Qwen2Config, consumed: Optional[Set[str]] = None,
) -> Dict[str, torch.Tensor]:
    """An HF Qwen2 state dict (names with or without the ``model.`` prefix)
    -> a :class:`Qwen2Model` state dict, tensors as they are (both store
    linear weights [out, in]).  Raises ``KeyError`` on a missing tensor;
    ``consumed`` receives the names read."""
    def get(name):
        for cand in (name, f"model.{name}"):
            if cand in tensors:
                if consumed is not None:
                    consumed.add(cand)
                return tensors[cand]
        raise KeyError(name)

    out = {"embed_tokens.weight": get("embed_tokens.weight"), "norm.weight": get("norm.weight")}
    for i in range(cfg.num_hidden_layers):
        for hf, ours in _HF_LAYER_KEYS.items():
            if ours.endswith("bias") and not cfg.attention_bias:
                continue
            out[f"layers.{i}.{ours}"] = get(f"layers.{i}.{hf}")
    if not cfg.tie_word_embeddings:
        if "lm_head.weight" not in tensors:
            raise KeyError("lm_head.weight (untied config)")
        if consumed is not None:
            consumed.add("lm_head.weight")
        out["lm_head.weight"] = tensors["lm_head.weight"]
    return out


def state_dict_to_hf(llm: "Qwen2Model") -> Dict[str, torch.Tensor]:
    """Inverse of :func:`hf_to_state_dict`: the HF names (``model.``
    prefixed, ``lm_head.weight`` when untied), tensors as they are; a
    quantized projection gives its dequantized kernel in bf16, and LoRA is
    folded into its kernel, as the JAX exporter's
    ``merge_lora(dequantize_llm(...))``.  Prefix tuning and llama-adapter
    leaves have no HF name and stay out (``export_peft_adapters``)."""
    from ps_slm_tpu_torch.models.lora import merge_lora
    from ps_slm_tpu_torch.models.quantization import dequantize_state_dict

    sd = merge_lora(dequantize_state_dict(llm.state_dict()))
    out = {"model.embed_tokens.weight": sd["embed_tokens.weight"],
           "model.norm.weight": sd["norm.weight"]}
    for i in range(llm.cfg.num_hidden_layers):
        for hf, ours in _HF_LAYER_KEYS.items():
            if f"layers.{i}.{ours}" in sd:
                out[f"model.layers.{i}.{hf}"] = sd[f"layers.{i}.{ours}"]
    if "lm_head.weight" in sd:
        out["lm_head.weight"] = sd["lm_head.weight"]
    return out


def load_hf_checkpoint(
    path: str, cfg: Optional[Qwen2Config] = None,
) -> Tuple[Dict[str, torch.Tensor], Qwen2Config]:
    """(state dict, config) of an HF Qwen2 directory: ``config.json``
    (unless ``cfg`` is given) and every ``*.safetensors`` file.  Tensors
    stay in the file's dtype on the CPU; the caller casts them once into
    the model.  A checkpoint without q/k/v biases gives a bias-free config."""
    if cfg is None:
        with open(os.path.join(path, "config.json")) as f:
            cfg = Qwen2Config.from_hf(json.load(f))
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {path}")
    tensors: Dict[str, torch.Tensor] = {}
    for fname in files:
        tensors.update(read_safetensors(os.path.join(path, fname)))
    if not any(k.endswith("layers.0.self_attn.q_proj.bias") for k in tensors):
        cfg = dataclasses.replace(cfg, attention_bias=False)
    return hf_to_state_dict(tensors, cfg), cfg
