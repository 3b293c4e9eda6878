"""PEFT adapters of the Qwen2 LLM: LoRA, prefix tuning and llama-adapter.

Counterpart of ``ps_slm_tpu/models/lora.py``.  The JAX package keeps the
adapters as extra leaves of the stacked layer tree; here they are extra
parameters of each layer's modules, under the same leaf names, so
:mod:`ps_slm_tpu_torch.convert` carries a JAX tree across leaf by leaf:

* LoRA (:func:`add_lora`): ``lora_a`` [in, r], ``lora_b`` [r, out] (the
  JAX layout, applied as ``((x @ A) @ B) * scale``) and a ``lora_scale``
  buffer (alpha / r, the model's dtype) on each targeted projection
  (``nn.Linear`` or the int8 / int4 ``QuantLinear``: QLoRA);
* prefix tuning (:func:`add_prefix_tuning`): ``prefix_k`` / ``prefix_v``
  [P, Hkv, D] on each block, an un-rotated key/value prefix every query
  sees;
* llama-adapter (:func:`add_llama_adapter`): ``adaption_prompt`` [P, H]
  and a zero ``adaption_gate`` on each block, and a frozen 0/1
  ``adaption_mask`` buffer selecting the top ``adapter_layers`` layers.

Each draws from the caller's ``torch.Generator`` with the JAX package's
init laws (the values differ from JAX's draws; the tests carry the JAX
leaves across).  :func:`merge_lora` folds LoRA into the base kernels of a
state dict, for the export.  ``lora_dropout`` (peft's inverted dropout on
the adapter input, training only) takes keep masks drawn outside the
blocks (:func:`lora_dropout_masks`), so a recomputed block (remat) sees the
same masks as its first run.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ps_slm_tpu_torch.models.layers import normal_, uniform_
from ps_slm_tpu_torch.ops import RowBlock, draw_rows

# the JAX package's per-projection dropout index (``qwen2._block``'s ctx(i))
LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
# the adapters' entries of a projection and of a block (parameters and
# buffers), and those that train under PEFT (``tasu.trainable_mask``)
LORA_LEAVES = ("lora_a", "lora_b", "lora_scale")
BLOCK_LEAVES = ("prefix_k", "prefix_v", "adaption_prompt", "adaption_gate", "adaption_mask")
ADAPTER_LEAVES = ("lora_a", "lora_b", "prefix_k", "prefix_v", "adaption_prompt",
                  "adaption_gate")


def lora_targets(block: nn.Module) -> List[str]:
    """The projections of ``block`` that carry LoRA, in dropout-index order."""
    return [n for n in LORA_TARGETS if getattr(getattr(block, n), "lora_a", None) is not None]


def lora_delta(lin: nn.Module, x: torch.Tensor, keep: Optional[torch.Tensor] = None,
               rate: float = 0.0, part: Optional[Tuple[str, slice]] = None
               ) -> Optional[torch.Tensor]:
    """``((x' @ A) @ B) * scale`` of ``lin``'s LoRA (None without one),
    where x' is x under the keep mask ``keep`` scaled by 1 / (1 - rate),
    zeros elsewhere, or x itself.  Under tensor parallelism ``part`` names
    this rank's block of a sharded base (A and B stay whole, and the mask
    is drawn at the whole input's width): ``("col", cols)``, the output
    columns ``cols`` (``x' @ A @ B[:, cols]``); ``("row", rows)``, the
    input rows ``rows`` of a row-parallel base, x holding only those
    (``(x' @ A[rows]) @ B``, a partial sum the caller reduces)."""
    a = getattr(lin, "lora_a", None)
    if a is None:
        return None
    b = lin.lora_b
    if part is not None and part[0] == "row":
        a = a[part[1]]
        keep = None if keep is None else keep[..., part[1]]
    elif part is not None:
        b = b[:, part[1]]
    if keep is not None:
        x = torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)
    return ((x @ a) @ b) * lin.lora_scale


def lora_dropout_masks(block: nn.Module, x_shape, rate: float, generator: torch.Generator,
                       device, rows: Optional[RowBlock] = None) -> Dict[str, torch.Tensor]:
    """Bernoulli(1 - rate) keep masks for one block's LoRA inputs, one per
    adapted projection in ``LORA_TARGETS`` order, each the shape of that
    projection's input (``x_shape[:-1] + (in_features,)``); with ``rows``,
    its rows of the masks for the global batch."""
    lead = tuple(x_shape[:-1])

    def draw(shape):
        return torch.rand(shape, generator=generator, device=device)

    return {
        n: draw_rows(draw, lead + (getattr(block, n).in_features,), rows) < 1.0 - rate
        for n in lora_targets(block)
    }


@torch.no_grad()
def add_lora(llm: nn.Module, peft_cfg, generator: torch.Generator) -> nn.Module:
    """Attach LoRA to the targeted projections of every layer of ``llm`` (a
    ``Qwen2Model``, fp or quantized), in place: A kaiming-uniform with bound
    1 / sqrt(in) (peft's default), B zeros, scale alpha / r, in the
    embedding's dtype.  Targets are taken in sorted order, each drawn for
    all layers at once, as the JAX ``add_lora``."""
    r = peft_cfg.r
    ref = llm.embed_tokens.weight
    dtype, dev = ref.dtype, ref.device
    for name in sorted(set(peft_cfg.target_modules)):
        if name not in LORA_TARGETS:
            continue
        d_in = getattr(llm.layers[0], name).in_features
        a = torch.empty(len(llm.layers), d_in, r, dtype=dtype, device=dev)
        uniform_(a, 1.0 / math.sqrt(d_in), generator)
        for i, layer in enumerate(llm.layers):
            lin = getattr(layer, name)
            lin.lora_a = nn.Parameter(a[i].clone())
            lin.lora_b = nn.Parameter(torch.zeros(r, lin.out_features, dtype=dtype, device=dev))
            lin.register_buffer("lora_scale", torch.tensor(peft_cfg.lora_alpha / r,
                                                           dtype=dtype, device=dev))
    return llm


@torch.no_grad()
def add_prefix_tuning(llm: nn.Module, peft_cfg, generator: torch.Generator) -> nn.Module:
    """A learned key/value prefix of ``num_virtual_tokens`` positions on
    every layer, drawn N(0, 1 / head_dim), in place."""
    cfg = llm.cfg
    ref = llm.embed_tokens.weight
    shape = (cfg.num_hidden_layers, peft_cfg.num_virtual_tokens, cfg.num_key_value_heads,
             cfg.head_dim)
    std = 1.0 / math.sqrt(cfg.head_dim)
    for leaf in ("prefix_k", "prefix_v"):
        full = torch.empty(shape, dtype=ref.dtype, device=ref.device)
        normal_(full, std, generator)
        for i, layer in enumerate(llm.layers):
            setattr(layer, leaf, nn.Parameter(full[i].clone()))
    return llm


@torch.no_grad()
def add_llama_adapter(llm: nn.Module, peft_cfg, generator: torch.Generator) -> nn.Module:
    """Zero-init gated adaption prompts, in place: ``adaption_prompt``
    [adapter_len, hidden] N(0, 1) and ``adaption_gate`` 0 on every layer
    (all train, as in JAX), and the frozen ``adaption_mask`` buffer 1 on the
    top ``adapter_layers`` layers, 0 below (whose prompt and gate get zero
    gradients)."""
    cfg = llm.cfg
    ref = llm.embed_tokens.weight
    n = cfg.num_hidden_layers
    n_adapt = min(peft_cfg.adapter_layers, n)
    prompt = torch.empty(n, peft_cfg.adapter_len, cfg.hidden_size, dtype=ref.dtype,
                         device=ref.device)
    normal_(prompt, 1.0, generator)
    for i, layer in enumerate(llm.layers):
        layer.adaption_prompt = nn.Parameter(prompt[i].clone())
        layer.adaption_gate = nn.Parameter(torch.zeros((), dtype=ref.dtype, device=ref.device))
        layer.adaption_mask = torch.tensor(float(i >= n - n_adapt), dtype=ref.dtype,
                                           device=ref.device)
    return llm


def add_peft(llm: nn.Module, peft_cfg, generator: torch.Generator) -> nn.Module:
    """The ``peft_method`` adapter of ``peft_cfg`` on ``llm``, in place."""
    method = peft_cfg.peft_method
    if method == "lora":
        return add_lora(llm, peft_cfg, generator)
    if method == "prefix":
        return add_prefix_tuning(llm, peft_cfg, generator)
    if method == "llama_adapter":
        return add_llama_adapter(llm, peft_cfg, generator)
    raise NotImplementedError(
        f"peft_method={method!r}; 'lora', 'prefix' and 'llama_adapter' are supported")


@torch.no_grad()
def merge_lora(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A ``Qwen2Model`` state dict with each LoRA folded into its base
    kernel and the LoRA entries dropped (for the export): the fp32 sum of
    the base and (A @ B) * scale, in the base weight's dtype; an int8 or
    int4 base is dequantized in fp32 and the merged weight is bf16 (it
    cannot stay quantized without a second rounding), as the JAX
    ``merge_lora``."""
    from ps_slm_tpu_torch.models.quantization import dequantize_kernel, dequantize_kernel4

    out = dict(state)
    for key in [k for k in state if k.endswith(".lora_a")]:
        base = key[: -len(".lora_a")]
        a, b, scale = (out.pop(f"{base}.{n}") for n in ("lora_a", "lora_b", "lora_scale"))
        delta = (a.float() @ b.float()) * scale.float()               # [in, out]
        if f"{base}.weight" in out:
            w = out[f"{base}.weight"]
            out[f"{base}.weight"] = (w.float() + delta.T).to(w.dtype)
            continue
        if f"{base}.q8" in out:
            node = {n: out.pop(f"{base}.{n}") for n in ("q8", "scale")}
            kernel = dequantize_kernel(node, torch.float32)
        else:
            node = {n: out.pop(f"{base}.{n}") for n in ("q4", "scale4")}
            kernel = dequantize_kernel4(node, torch.float32)
        out[f"{base}.weight"] = (kernel + delta).to(torch.bfloat16).T
    return out
