"""The benchmark's weights, made from the seed on the device.

The names and shapes are the port's ``state_dict`` keys of the encoder,
the projector and the LLM, so that the same tensors are handed to the
port (``load_state_dict``) and to the reference.  Each kind of leaf is
drawn for all layers at once, in the dtype the configuration serves, from
a ``torch.Generator`` of its own part (so the encoder's weights are the
same whether or not an LLM is made beside them):

* linear weights N(0, 1 / in), biases N(0, 0.02^2);
* norm weights 1 + N(0, 0.05^2), LayerNorm biases N(0, 0.05^2); the
  projector's LayerNorm as the recipe initialises it (1 and 0), and its
  second bias 0;
* the CTC head's bias 0, and its blank row and bias calibrated
  (:func:`_calibrate_blank`): with random weights the posterior is flat
  and PSD would drop nothing, so the blank row puts back a trained
  model's blank share, pauses blank and bursts not;
* the global CMVN of the front end: shifts -(20 + N(0, 1)), scales
  0.25 + U(0, 0.05), about the log-mel level of the traffic's audio.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterable, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _gen(seed: int, part: str, device) -> torch.Generator:
    h = int.from_bytes(hashlib.sha256(f"{seed}:{part}".encode()).digest()[:8], "little")
    return torch.Generator(device=device).manual_seed(h % (2 ** 63))


def _draw(gen, device, dtype, n: int, shape, kind: str, scale: float) -> torch.Tensor:
    """[n, *shape] of one kind of leaf: "normal" (std ``scale``), "one"
    (1 + N(0, scale^2)) or "zero"."""
    full = (n, *shape)
    if kind == "zero":
        return torch.zeros(full, device=device, dtype=dtype)
    x = torch.randn(full, generator=gen, device=device, dtype=dtype)
    x.mul_(scale)
    if kind == "one":
        x.add_(1.0)
    return x


def _stacked(prefixes: List[str], leaves: Iterable[Tuple[str, tuple, str, float]],
             gen, device, dtype) -> Dict[str, torch.Tensor]:
    out = {}
    for name, shape, kind, scale in leaves:
        block = _draw(gen, device, dtype, len(prefixes), shape, kind, scale)
        for i, p in enumerate(prefixes):
            out[f"{p}{name}"] = block[i]
    return out


def _sanm_leaves(d_in: int, d: int, ff: int, k: int):
    return [
        ("norm1.weight", (d_in,), "one", 0.05), ("norm1.bias", (d_in,), "normal", 0.05),
        ("qkv.weight", (3 * d, d_in), "normal", d_in ** -0.5), ("qkv.bias", (3 * d,), "normal", 0.02),
        ("out.weight", (d, d), "normal", d ** -0.5), ("out.bias", (d,), "normal", 0.02),
        ("fsmn.weight", (d, 1, k), "normal", (3 * d) ** -0.5),
        ("norm2.weight", (d,), "one", 0.05), ("norm2.bias", (d,), "normal", 0.05),
        ("w1.weight", (ff, d), "normal", d ** -0.5), ("w1.bias", (ff,), "normal", 0.02),
        ("w2.weight", (d, ff), "normal", ff ** -0.5), ("w2.bias", (d,), "normal", 0.02),
    ]


def encoder(cfg: Dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The SenseVoice encoder's state dict (``configs/<name>.json``'s
    ``encoder`` widths)."""
    e = cfg["encoder"]
    d, ff, k, v = e["output_size"], e["linear_units"], e["kernel_size"], e["vocab_size"]
    gen = _gen(seed, "encoder", device)
    w = _stacked(["encoders0."], _sanm_leaves(e["input_size"], d, ff, k), gen, device, dtype)
    w.update(_stacked([f"encoders.{i}." for i in range(e["num_blocks"] - 1)]
                      + [f"tp_encoders.{i}." for i in range(e["tp_blocks"])],
                      _sanm_leaves(d, d, ff, k), gen, device, dtype))
    w.update(_stacked(["after_norm.", "tp_norm."], [("weight", (d,), "one", 0.05),
                                                    ("bias", (d,), "normal", 0.05)],
                      gen, device, dtype))
    w["ctc_lo.weight"] = _draw(gen, device, dtype, 1, (v, d), "normal", d ** -0.5)[0]
    w["ctc_lo.bias"] = torch.zeros(v, device=device, dtype=dtype)
    w["query_embed"] = _draw(gen, device, dtype, 1, (16, e["input_size"]), "normal", 1.0)[0]
    _calibrate_blank(cfg, seed, device, w)
    return w


_BLANK_ROWS: Dict = {}


def _calibrate_blank(cfg: Dict, seed: int, device, w: Dict[str, torch.Tensor]) -> None:
    """Set the CTC head's blank row and bias so that pauses read blank and
    bursts do not, as a trained encoder's spiky posterior does: the
    reference encoder runs on a probe utterance (``traffic.probe``); the
    blank row is ``blank_gain`` times the unit vector from the bursts'
    mean hidden state to the pauses', and the bias puts the blank
    probability at the PSD threshold midway between the two means.  The
    row is worked out once a process and seed, and reused."""
    from portbench import traffic
    from portbench.reference import encoder as enc
    from portbench.reference import frontend

    e, blank = cfg["encoder"], cfg["encoder"].get("blank_id", 0)
    key = (seed, str(device), tuple(sorted(e.items())), w["ctc_lo.weight"].dtype)
    if key not in _BLANK_ROWS:
        samples, burst = traffic.probe(seed, device, duty=cfg["weights"]["burst_duty"])
        fp = {k: v.float() for k, v in w.items()}
        with torch.no_grad():
            hidden, logits = enc.encode(fp, e, frontend.features(samples, cmvn(cfg, seed, device)),
                                        (0, 1, 2, 2))
        hidden, logits = hidden[4:], logits[4:]
        pause, speech = hidden[~burst].mean(0), hidden[burst].mean(0)
        u = (pause - speech) / (pause - speech).norm()
        mid = 0.5 * float(u @ (pause + speech))
        others = torch.cat([logits[:, :blank], logits[:, blank + 1:]], dim=1)
        lse = float(torch.logsumexp(others, dim=1).mean())
        gain = cfg["weights"]["blank_gain"]
        threshold = cfg["weights"]["blank_threshold"]
        level = lse + math.log(threshold / (1 - threshold))
        _BLANK_ROWS[key] = (gain * u, level - gain * mid)
    row, bias = _BLANK_ROWS[key]
    w["ctc_lo.weight"][blank] = row.to(w["ctc_lo.weight"].dtype)
    w["ctc_lo.bias"][blank] = bias


def projector(cfg: Dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The linear-silu projector: LayerNorm over the posterior, 2048 SiLU,
    the LLM's width."""
    v, h, o = cfg["encoder"]["vocab_size"], cfg["projector"]["hidden"], cfg["llm"]["hidden_size"]
    gen = _gen(seed, "projector", device)
    return {
        "norm.weight": torch.ones(v, device=device, dtype=dtype),
        "norm.bias": torch.zeros(v, device=device, dtype=dtype),
        "ffn1.weight": _draw(gen, device, dtype, 1, (h, v), "normal", v ** -0.5)[0],
        "ffn1.bias": _draw(gen, device, dtype, 1, (h,), "normal", (3 * v) ** -0.5)[0],
        "ffn2.weight": _draw(gen, device, dtype, 1, (o, h), "normal", h ** -0.5)[0],
        "ffn2.bias": torch.zeros(o, device=device, dtype=dtype),
    }


def llm(cfg: Dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The Qwen2 LLM (tied embeddings), every layer."""
    c = cfg["llm"]
    h, ff = c["hidden_size"], c["intermediate_size"]
    qd = c["num_attention_heads"] * c["head_dim"]
    kvd = c["num_key_value_heads"] * c["head_dim"]
    gen = _gen(seed, "llm", device)
    leaves = [
        ("input_layernorm.weight", (h,), "one", 0.05),
        ("post_attention_layernorm.weight", (h,), "one", 0.05),
        ("q_proj.weight", (qd, h), "normal", h ** -0.5), ("q_proj.bias", (qd,), "normal", 0.02),
        ("k_proj.weight", (kvd, h), "normal", h ** -0.5), ("k_proj.bias", (kvd,), "normal", 0.02),
        ("v_proj.weight", (kvd, h), "normal", h ** -0.5), ("v_proj.bias", (kvd,), "normal", 0.02),
        ("o_proj.weight", (h, qd), "normal", qd ** -0.5),
        ("gate_proj.weight", (ff, h), "normal", h ** -0.5),
        ("up_proj.weight", (ff, h), "normal", h ** -0.5),
        ("down_proj.weight", (h, ff), "normal", ff ** -0.5),
    ]
    w = _stacked([f"layers.{i}." for i in range(c["num_hidden_layers"])], leaves, gen, device, dtype)
    w["embed_tokens.weight"] = _draw(gen, device, dtype, 1, (c["vocab_size"], h), "normal",
                                     h ** -0.5)[0]
    w["norm.weight"] = _draw(gen, device, dtype, 1, (h,), "one", 0.05)[0]
    return w


def cmvn(cfg: Dict, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neg_mean, inv_std), fp32 [input_size]."""
    d = cfg["encoder"]["input_size"]
    gen = _gen(seed, "cmvn", device)
    neg_mean = -(20.0 + torch.randn(d, generator=gen, device=device))
    inv_std = 0.25 + 0.05 * torch.rand(d, generator=gen, device=device)
    return neg_mean, inv_std


PARTS = {"encoder": encoder, "projector": projector, "llm": llm}


def make(cfg: Dict, seed: int, device, parts=("encoder", "projector", "llm"),
         dtype=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Each asked part's state dict, in the configuration's dtype (or
    ``dtype``)."""
    dtype = dtype or DTYPES[cfg["dtype"]]
    with torch.no_grad():
        return {p: PARTS[p](cfg, seed, device, dtype) for p in parts}


def fp32(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in state.items()}

