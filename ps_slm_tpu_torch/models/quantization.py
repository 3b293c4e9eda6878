"""Int8 / int4 weight-only quantization of the LLM, and the int8 KV cache.

Counterpart of ``ps_slm_tpu/models/quantization.py``, with the same codes
and scales bit for bit (``torch.round`` and ``jnp.round`` both round half to
even).  Kernels are in the JAX layout [..., in, out]:

* int8: symmetric per output channel, ``W[i, o] = q8[i, o] * scale[o]``;
  the product is ``y = (x @ q8.to(x.dtype)) * scale.to(x.dtype)``, the scale
  on the output in x's dtype, the weight never dequantized first;
* int4: symmetric group-wise along the contraction axis (default group 128,
  one full-depth group when that does not divide the in-features), codes in
  [-7, 7]; the product contracts each group in x's dtype, then the groups
  with their scales in fp32.

torch has no 4-bit dtype a matmul can take, so the int4 codes live in an
int8 container, as the JAX package's own fallback keeps them
(``_q4_container_dtype``): int4 weights take int8's memory in the port.  The
products are plain PyTorch (the JAX package computes them outside any
Pallas kernel too).

:func:`quantize_llm` swaps the projection ``nn.Linear`` modules of a
``Qwen2Model`` for :class:`~ps_slm_tpu_torch.models.qwen2.QuantLinear`
modules in place; :func:`dequantize_llm` swaps them back.  The KV cache
functions quantize one fp32 scale per [head_dim] vector.

Rounding of the scales, as the JAX package rounds them on every device:
the weight scales come from an eager JAX call (``model_factory``, the
checkpoint import), an IEEE division by 127 (or 7), so the port divides by
a device tensor (:func:`_div`: CUDA turns a division by a Python scalar
into a multiply by its reciprocal, an ulp apart at times, and codes moved
with it); the KV scales come from the jitted forward, where XLA folds the
division by 127 into a multiply by its fp32 reciprocal, so the port
multiplies by that value.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ps_slm_tpu_torch.ops import fp32_reciprocal

QUANT_TARGETS = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
)
_KV_STEP = fp32_reciprocal(127.0)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as an IEEE division on the CPU and the card alike."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def quantize_kernel(kernel: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., in, out] -> {"q8": int8 [..., in, out], "scale": fp32 [..., out]}."""
    w = kernel.float()
    amax = w.abs().amax(dim=-2, keepdim=True)                # per output channel
    scale = _div(amax.clamp(min=1e-8), 127.0)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q8": q, "scale": scale.squeeze(-2)}


def dequantize_kernel(node: Dict[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    return (node["q8"].float() * node["scale"][..., None, :]).to(dtype)


def q8_matmul(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """y = (x @ q8) * scale, in x's dtype."""
    return (x @ q8.to(x.dtype)) * scale.to(x.dtype)


def _group_size(in_features: int, group_size: int) -> int:
    """The requested group size when it divides the in-features, else one
    full-depth group (tiny test models)."""
    if group_size > 0 and in_features % group_size == 0:
        return group_size
    return in_features


def quantize_kernel4(kernel: torch.Tensor, group_size: int = 128) -> Dict[str, torch.Tensor]:
    """[..., in, out] -> {"q4": int8 [..., in, out] holding [-7, 7],
    "scale4": fp32 [..., in / gs, out]}."""
    w = kernel.float()
    lead, (i, o) = w.shape[:-2], w.shape[-2:]
    gs = _group_size(i, group_size)
    wg = w.reshape(*lead, i // gs, gs, o)
    amax = wg.abs().amax(dim=-2, keepdim=True)
    scale = _div(amax.clamp(min=1e-8), 7.0)
    q = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int8)
    return {"q4": q.reshape(*lead, i, o), "scale4": scale.squeeze(-2)}


def dequantize_kernel4(node: Dict[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    q4, scale = node["q4"], node["scale4"]
    lead, (i, o) = q4.shape[:-2], q4.shape[-2:]
    gs = i // scale.shape[-2]
    w = q4.float().reshape(*lead, i // gs, gs, o) * scale[..., :, None, :]
    return w.reshape(*lead, i, o).to(dtype)


def q4_matmul(x: torch.Tensor, q4: torch.Tensor, scale4: torch.Tensor) -> torch.Tensor:
    """Group-wise int4 product of x [..., in] and a 2-D [in, out] block: a
    batched product per group in x's dtype, then the fp32 contraction of the
    groups with their scales."""
    i, o = q4.shape
    g = scale4.shape[0]
    w = q4.to(x.dtype).reshape(g, i // g, o)
    xg = x.reshape(*x.shape[:-1], g, i // g)
    part = torch.einsum("...gi,gio->...go", xg, w)
    y = torch.einsum("...go,go->...o", part.float(), scale4.float())
    return y.to(x.dtype)


def quantize_llm(llm: nn.Module, bits: int = 8, group_size: int = 128) -> nn.Module:
    """Quantize the projection kernels of every layer of ``llm`` (a
    ``Qwen2Model``) in place, from the weights in the model's dtype; returns
    ``llm``.  The biases stay as they are."""
    from ps_slm_tpu_torch.models.qwen2 import QuantLinear

    if bits not in (4, 8):
        raise ValueError(f"quant_bits must be 4 or 8, got {bits}")
    model_type = getattr(llm.cfg, "model_type", "qwen2")
    if model_type != "qwen2":
        raise NotImplementedError(
            f"quantize_llm: the {model_type} decoder has no int{bits} weights (its latent "
            "attention and stacked experts are not quantized; ROADMAP queue C)")
    for layer in llm.layers:
        for name in QUANT_TARGETS:
            lin = getattr(layer, name)
            if isinstance(lin, nn.Linear):
                setattr(layer, name, QuantLinear.from_linear(lin, bits, group_size))
    return llm


def dequantize_llm(llm: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Inverse of :func:`quantize_llm`, in place: each quantized projection
    becomes an ``nn.Linear`` holding the dequantized kernel in ``dtype``."""
    from ps_slm_tpu_torch.models.qwen2 import QuantLinear

    for layer in llm.layers:
        for name in QUANT_TARGETS:
            lin = getattr(layer, name)
            if isinstance(lin, QuantLinear):
                setattr(layer, name, lin.to_linear(dtype))
    return llm


def quantize_state_dict(state: Dict[str, torch.Tensor], bits: int, group_size: int,
                        dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A dense ``Qwen2Model`` state dict with each projection's ``weight``
    [out, in] cast to ``dtype`` (the model's) and replaced by its codes and
    scales: what a checkpoint import loads into a quantized model, as the
    JAX import re-quantizes with the model's own scheme."""
    out = {}
    for k, v in state.items():
        base, _, leaf = k.rpartition(".")
        if leaf == "weight" and base.rpartition(".")[2] in QUANT_TARGETS:
            w = v.to(dtype).T
            node = quantize_kernel(w) if bits == 8 else quantize_kernel4(w, group_size)
            out.update({f"{base}.{n}": t for n, t in node.items()})
        else:
            out[k] = v
    return out


def dequantize_state_dict(state: Dict[str, torch.Tensor], dtype=torch.bfloat16):
    """A ``Qwen2Model`` state dict with each quantized projection's codes and
    scales replaced by its dequantized ``weight`` [out, in] in ``dtype`` (the
    JAX ``dequantize_llm``'s default, bf16, for the checkpoint export)."""
    out = {}
    for k, v in state.items():
        base, _, leaf = k.rpartition(".")
        if leaf == "q8":
            node = {"q8": v, "scale": state[f"{base}.scale"]}
            out[f"{base}.weight"] = dequantize_kernel(node, dtype).T
        elif leaf == "q4":
            node = {"q4": v, "scale4": state[f"{base}.scale4"]}
            out[f"{base}.weight"] = dequantize_kernel4(node, dtype).T
        elif not (leaf == "scale" and f"{base}.q8" in state
                  or leaf == "scale4" and f"{base}.q4" in state):
            out[k] = v
    return out


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8 for KV-cache entries: one fp32 scale per
    [..., head_dim] vector (amax / 127 over the last axis)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp(min=1e-8) * _KV_STEP
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return q.to(dtype) * scale[..., None].to(dtype)


def quant_spec(llm: nn.Module) -> Optional[Tuple[int, int]]:
    """(bits, group_size) of a quantized ``Qwen2Model``, or None: the scheme
    a checkpoint import re-quantizes fresh weights with."""
    from ps_slm_tpu_torch.models.qwen2 import QuantLinear

    for m in llm.modules():
        if isinstance(m, QuantLinear):
            if m.bits == 8:
                return 8, 0
            return 4, m.q4.shape[0] // m.scale4.shape[0]
    return None
