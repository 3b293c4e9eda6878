"""The benchmark's weights for a DeepSeek-V3 LLM (``model_type``
``deepseek_v3``), made from the seed on the device.

The encoder, its calibrated CTC head, the projector and the CMVN are
``weights.py``'s, drawn by its functions.  The LLM's leaves carry the
port's ``state_dict`` names (``models/deepseek_v3.py``: HF's within a
layer, each layer's routed experts stacked as ``mlp.experts.gate_up_proj``
[E, 2I, H] and ``mlp.experts.down_proj`` [E, H, I]), each kind drawn for
all its layers at once from the LLM's own generator, in the
configuration's dtype:

* linear weights N(0, 1 / in), the router's included;
* norm weights 1 + N(0, 0.05^2);
* the router's ``e_score_correction_bias`` N(0, 0.01^2): it moves the
  choice of a few experts, as a trained bias does, and never the weights;
* every routed expert drawn on its own, so a wrong choice of expert
  changes the output as much as a wrong expert would.

In bf16 the whole Moonlight-16B-A3B LLM is 31.9 GB; the stacked blocks are
views, so nothing is drawn twice.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench import weights

DTYPES = weights.DTYPES


def llm(cfg: Dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The DeepSeek-V3 LLM (untied ``lm_head``), every layer."""
    c = cfg["llm"]
    h, nh, n = c["hidden_size"], c["num_attention_heads"], c["num_hidden_layers"]
    dn, dr, dv, rank = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                        c["kv_lora_rank"])
    e, inter, ff = c["n_routed_experts"], c["moe_intermediate_size"], c["intermediate_size"]
    shared = inter * c["n_shared_experts"]
    dense = c["first_k_dense_replace"]
    gen = weights._gen(seed, "llm", device)
    attn = [
        ("input_layernorm.weight", (h,), "one", 0.05),
        ("post_attention_layernorm.weight", (h,), "one", 0.05),
        ("self_attn.q_proj.weight", (nh * (dn + dr), h), "normal", h ** -0.5),
        ("self_attn.kv_a_proj_with_mqa.weight", (rank + dr, h), "normal", h ** -0.5),
        ("self_attn.kv_a_layernorm.weight", (rank,), "one", 0.05),
        ("self_attn.kv_b_proj.weight", (nh * (dn + dv), rank), "normal", rank ** -0.5),
        ("self_attn.o_proj.weight", (h, nh * dv), "normal", (nh * dv) ** -0.5),
    ]
    w = weights._stacked([f"layers.{i}." for i in range(n)], attn, gen, device, dtype)
    w.update(weights._stacked([f"layers.{i}." for i in range(dense)], [
        ("mlp.gate_proj.weight", (ff, h), "normal", h ** -0.5),
        ("mlp.up_proj.weight", (ff, h), "normal", h ** -0.5),
        ("mlp.down_proj.weight", (h, ff), "normal", ff ** -0.5),
    ], gen, device, dtype))
    w.update(weights._stacked([f"layers.{i}." for i in range(dense, n)], [
        ("mlp.gate.weight", (e, h), "normal", h ** -0.5),
        ("mlp.gate.e_score_correction_bias", (e,), "normal", 0.01),
        ("mlp.experts.gate_up_proj", (e, 2 * inter, h), "normal", h ** -0.5),
        ("mlp.experts.down_proj", (e, h, inter), "normal", inter ** -0.5),
        ("mlp.shared_experts.gate_proj.weight", (shared, h), "normal", h ** -0.5),
        ("mlp.shared_experts.up_proj.weight", (shared, h), "normal", h ** -0.5),
        ("mlp.shared_experts.down_proj.weight", (h, shared), "normal", shared ** -0.5),
    ], gen, device, dtype))
    v = c["vocab_size"]
    w["embed_tokens.weight"] = weights._draw(gen, device, dtype, 1, (v, h), "normal", h ** -0.5)[0]
    w["lm_head.weight"] = weights._draw(gen, device, dtype, 1, (v, h), "normal", h ** -0.5)[0]
    w["norm.weight"] = weights._draw(gen, device, dtype, 1, (h,), "one", 0.05)[0]
    return w


PARTS = {"encoder": weights.encoder, "projector": weights.projector, "llm": llm}


def make(cfg: Dict, seed: int, device, parts=("encoder", "projector", "llm"),
         dtype=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Each asked part's state dict, in the configuration's dtype (or
    ``dtype``)."""
    dtype = dtype or DTYPES[cfg["dtype"]]
    with torch.no_grad():
        return {p: PARTS[p](cfg, seed, device, dtype) for p in parts}
