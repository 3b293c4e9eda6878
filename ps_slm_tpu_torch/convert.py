"""Map the JAX package's parameter tree onto the port's modules.

``from_jax_params`` takes ``TasuModel.params`` of the JAX package with every
leaf already a numpy array (``jax.tree_util.tree_map(np.asarray, params)``),
so this module never imports JAX, and returns a state dict for
:class:`ps_slm_tpu_torch.models.tasu.TasuModel`:

* stacked layer axes (``encoders``, ``tp_encoders``, ``llm.layers``) split
  into one module per layer;
* linear kernels [in, out] transposed to ``nn.Linear``'s [out, in];
* the FSMN kernel [k, 1, C] transposed to conv1d's [C, 1, k], and the
  cov1d projector's [k, in, out] to [out, in, k];
* the q-former's list of layers one module a layer;
* tied embeddings: no ``lm_head`` in the tree, none in the state dict;
* quantized LLM projections (``q8``/``scale`` or ``q4``/``scale4``, JAX
  layout [in, out]) carried as they are, into the buffers of a model
  quantized with the same scheme (``models.quantization.quantize_llm``);
* the PEFT leaves (``models/lora.py``) split per layer under their own
  names: a projection's ``lora_a`` [in, r] / ``lora_b`` [r, out] in the
  JAX layout and ``lora_scale`` a scalar; a block's ``prefix_k`` /
  ``prefix_v`` [P, Hkv, D], ``adaption_prompt`` [P, H] and the scalars
  ``adaption_gate`` / ``adaption_mask``, into a model with the same
  adapter attached.

Tensors come out fp32, integer codes int8 (a JAX int4 leaf arrives as an
``ml_dtypes.int4`` array); ``load_state_dict`` casts them to the model's
dtypes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ps_slm_tpu_torch.models.lora import BLOCK_LEAVES, LORA_LEAVES

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _codes(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int8))


def _linear(p: Dict[str, Any], name: str, out: StateDict) -> None:
    extra = set(p) - {"kernel", "bias", "q8", "scale", "q4", "scale4", *LORA_LEAVES}
    if extra:
        raise ValueError(f"{name}: unknown leaves {sorted(extra)}")
    for leaf in LORA_LEAVES:
        if leaf in p:
            out[f"{name}.{leaf}"] = _t(p[leaf])
    if "q8" in p:
        out[f"{name}.q8"], out[f"{name}.scale"] = _codes(p["q8"]), _t(p["scale"])
    elif "q4" in p:
        out[f"{name}.q4"], out[f"{name}.scale4"] = _codes(p["q4"]), _t(p["scale4"])
    else:
        out[f"{name}.weight"] = _t(p["kernel"]).T.contiguous()
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def _norm(p: Dict[str, Any], name: str, out: StateDict) -> None:
    out[f"{name}.weight"] = _t(p["weight"])
    out[f"{name}.bias"] = _t(p["bias"])


def _layer(tree, i: int):
    """Layer ``i`` of a tree whose leaves carry a leading layer axis."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _n_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[0]


def _sanm(lp: Dict[str, Any], name: str, out: StateDict) -> None:
    _norm(lp["norm1"], f"{name}.norm1", out)
    _norm(lp["norm2"], f"{name}.norm2", out)
    for lin in ("qkv", "out", "w1", "w2"):
        _linear(lp[lin], f"{name}.{lin}", out)
    out[f"{name}.fsmn.weight"] = _t(lp["fsmn"]["kernel"]).permute(2, 1, 0).contiguous()


def encoder_state_dict(tree: Dict[str, Any]) -> StateDict:
    """JAX SenseVoice params -> ``SenseVoiceEncoder`` state dict."""
    out: StateDict = {}
    _sanm(tree["encoders0"], "encoders0", out)
    for stack in ("encoders", "tp_encoders"):
        layers: Optional[dict] = tree[stack]
        if layers is not None:
            for i in range(_n_layers(layers)):
                _sanm(_layer(layers, i), f"{stack}.{i}", out)
    _norm(tree["after_norm"], "after_norm", out)
    _norm(tree["tp_norm"], "tp_norm", out)
    _linear(tree["ctc_lo"], "ctc_lo", out)
    out["query_embed"] = _t(tree["query_embed"])
    return out


def projector_state_dict(tree: Dict[str, Any]) -> StateDict:
    """JAX projector params -> the port projector's state dict, for each of
    the six: linears transposed, cov1d's conv kernel [k, in, out] to
    conv1d's [out, in, k], the q-former's ``layers`` list one module a
    layer (``ln_*`` its LayerNorms)."""
    out: StateDict = {}
    if "layers" in tree:      # q-former
        out["query"] = _t(tree["query"])
        _norm(tree["ln_embed"], "ln_embed", out)
        _linear(tree["out"], "out", out)
        _norm(tree["out_norm"], "out_norm", out)
        for i, layer in enumerate(tree["layers"]):
            for name, node in layer.items():
                (_norm if name.startswith("ln_") else _linear)(node, f"layers.{i}.{name}", out)
        return out
    for name, node in tree.items():
        if name == "conv":
            out["conv.weight"] = _t(node["kernel"]).permute(2, 1, 0).contiguous()
            out["conv.bias"] = _t(node["bias"])
        elif name == "norm":
            _norm(node, name, out)
        else:
            _linear(node, name, out)
    return out


_QWEN2_LINEARS = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
)


def qwen2_state_dict(tree: Dict[str, Any]) -> StateDict:
    """JAX Qwen2 params -> ``Qwen2Model`` state dict."""
    layers = tree["layers"]
    extra = set(layers) - set(_QWEN2_LINEARS) - set(BLOCK_LEAVES) - {
        "input_layernorm", "post_attention_layernorm"
    }
    if extra:
        raise ValueError(f"Qwen2 layers: unknown leaves {sorted(extra)}")
    out: StateDict = {"embed_tokens.weight": _t(tree["embed_tokens"])}
    for i in range(_n_layers(layers)):
        lp = _layer(layers, i)
        out[f"layers.{i}.input_layernorm.weight"] = _t(lp["input_layernorm"])
        out[f"layers.{i}.post_attention_layernorm.weight"] = _t(
            lp["post_attention_layernorm"]
        )
        for lin in _QWEN2_LINEARS:
            _linear(lp[lin], f"layers.{i}.{lin}", out)
        for leaf in BLOCK_LEAVES:
            if leaf in lp:
                out[f"layers.{i}.{leaf}"] = _t(lp[leaf])
    out["norm.weight"] = _t(tree["norm"])
    if "lm_head" in tree:
        out["lm_head.weight"] = _t(tree["lm_head"]).T.contiguous()
    return out


def from_jax_params(tree: Dict[str, Any]) -> StateDict:
    """JAX ``TasuModel.params`` (numpy leaves) -> ``TasuModel`` state dict."""
    out: StateDict = {}
    for prefix, part in (
        ("encoder", encoder_state_dict(tree["encoder"])),
        ("projector", projector_state_dict(tree["projector"])),
        ("llm", qwen2_state_dict(tree["llm"])),
    ):
        out.update({f"{prefix}.{k}": v for k, v in part.items()})
    return out
