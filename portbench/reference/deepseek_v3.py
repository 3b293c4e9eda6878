"""DeepSeek-V3's block (Moonlight-16B-A3B's ``config.json``, ``model_type``
``deepseek_v3``) over one sequence, float32.

Written from the published ``modeling_deepseek.py``:

* **Latent attention** (``q_lora_rank`` null): q is one projection to
  heads x (``qk_nope_head_dim`` + ``qk_rope_head_dim``); ``kv_a_proj_with_mqa``
  gives the latent ``c_kv`` (``kv_lora_rank`` wide, through its own RMSNorm)
  and one rotary key ``k_pe`` shared by every head; ``kv_b_proj`` expands
  the normed latent into each head's ``k_nope`` and ``v``.  The rotary
  part of q and k takes DeepSeek's layout: the 64 dimensions viewed as
  (32, 2), transposed, then rotate-half with theta ``rope_theta`` at
  positions 0..T-1.  Scores q . k scaled by (nope + rope)^-0.5, causal fp32
  softmax, the context through ``o_proj``.
* **Feed-forward**: the first ``first_k_dense_replace`` layers a SwiGLU of
  ``intermediate_size``; the rest a mixture: router logits in fp32, their
  sigmoid; the top ``num_experts_per_tok`` chosen by sigmoid +
  ``e_score_correction_bias`` (the bias chooses, it never weighs); their
  sigmoid scores renormalised and times ``routed_scaling_factor``; each
  chosen expert a SwiGLU of ``moe_intermediate_size``; the shared experts
  one SwiGLU of ``moe_intermediate_size * n_shared_experts`` added
  unweighted.
* A final RMSNorm and an untied ``lm_head``.

:func:`forward` may be handed the chosen experts of a program
(``force``): at the positions it marks, each MoE layer takes the
program's set in place of its own top k, with its own fp32 scores for
their weights, and reports by how much that set departs from its own
(:func:`deficit`).  So the logits of a program whose bf16 rounding
flipped a near-tie in a router are held to the same experts, and the
router is held on its own.

Weights are taken in whatever dtype they are handed and upcast layer by
layer as the layer runs, so a bf16 model of 32 GB never has a second
float32 copy.  ``fp8_weights`` rounds every projection and expert weight
to float8 e4m3 with one scale per output row (its largest magnitude to
448): the serving cell's control, one step below bf16.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.reference.precision import mm

_MODE = {"fp8": False}


@contextlib.contextmanager
def fp8_weights():
    _MODE["fp8"] = True
    try:
        yield
    finally:
        _MODE["fp8"] = False


def weight(w: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    """A projection's weight in float32 (e4m3-rounded per output row under
    :func:`fp8_weights`)."""
    x = w[name].float()
    if not _MODE["fp8"]:
        return x
    scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float, positions: torch.Tensor) -> torch.Tensor:
    """x [heads, T, d] at ``positions`` [T], in DeepSeek's layout: each
    pair (x[2i], x[2i+1]) brought to (i, d/2 + i), then rotate-half."""
    t, d = x.shape[1], x.shape[2]
    x = x.reshape(x.shape[0], t, d // 2, 2).transpose(2, 3).reshape(x.shape[0], t, d)
    inv = theta ** (-torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    ang = positions.to(x.device, torch.float32)[:, None] * inv[None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    a, b = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def swiglu(w, p: str, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(mm(x, weight(w, p + "gate_proj.weight").T))
    return mm(gate * mm(x, weight(w, p + "up_proj.weight").T), weight(w, p + "down_proj.weight").T)


def attention(w, cfg: Dict, p: str, y: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    t = y.shape[0]
    nh = cfg["num_attention_heads"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank = cfg["kv_lora_rank"]
    q = mm(y, weight(w, p + "q_proj.weight").T).reshape(t, nh, dn + dr).transpose(0, 1)
    kv_a = mm(y, weight(w, p + "kv_a_proj_with_mqa.weight").T)
    c_kv = rms_norm(kv_a[:, :rank], w[p + "kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    k_pe = rope(kv_a[None, :, rank:], cfg["rope_theta"], positions)       # [1, T, dr]
    kv = mm(c_kv, weight(w, p + "kv_b_proj.weight").T).reshape(t, nh, dn + dv).transpose(0, 1)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], cfg["rope_theta"], positions)], dim=-1)
    k = torch.cat([kv[..., :dn], k_pe.expand(nh, t, dr)], dim=-1)
    causal = torch.ones(t, t, dtype=torch.bool, device=y.device).tril()
    s = mm(q, k.transpose(1, 2)) * (dn + dr) ** -0.5
    att = mm(torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1), kv[..., dn:])
    return mm(att.transpose(0, 1).reshape(t, nh * dv), weight(w, p + "o_proj.weight").T)


def route(w, cfg: Dict, p: str, y: torch.Tensor, force: Optional[torch.Tensor] = None,
          forced: Optional[torch.Tensor] = None):
    """(chosen experts [T, k], their weights [T, k], the selection scores
    [T, E]: sigmoid + correction bias) of the router.  With ``force`` [T, k']
    the rows ``forced`` [T] marks take its sets, the rest their own top k'."""
    scores = torch.sigmoid(y @ w[p + "mlp.gate.weight"].float().T)
    biased = scores + w[p + "mlp.gate.e_score_correction_bias"].float()
    k = cfg["num_experts_per_tok"] if force is None else force.shape[1]
    pick = torch.topk(biased, k, dim=-1).indices
    if force is not None:
        pick = torch.where(forced[:, None], force.to(pick.device, torch.long), pick)
    wts = scores.gather(1, pick)
    if cfg.get("norm_topk_prob", True):
        wts = wts / (wts.sum(-1, keepdim=True) + 1e-20)
    return pick, wts * cfg["routed_scaling_factor"], biased


def deficit(biased: torch.Tensor, chosen: torch.Tensor, k: int) -> torch.Tensor:
    """[T]: how far each chosen set departs from the top ``k`` of the
    selection scores ``biased`` [T, E], in their units: the most that a
    chosen expert lies below the k-th score, or that a left-out expert of
    the top k lies above the (k+1)-th; 0 where the set is the top k.  A set
    of another size than k leaves out a top-k expert, or takes one below."""
    vals = biased.sort(dim=-1, descending=True).values
    kth, nxt = vals[:, k - 1:k], vals[:, k:k + 1]
    ours = torch.zeros_like(biased, dtype=torch.bool).scatter_(
        1, biased.topk(k, dim=-1).indices, True)
    theirs = torch.zeros_like(ours).scatter_(1, chosen.to(biased.device, torch.long), True)
    below = torch.where(theirs & ~ours, kth - biased, 0.0).amax(dim=-1)
    above = torch.where(ours & ~theirs, biased - nxt, 0.0).amax(dim=-1)
    return torch.maximum(below, above)


def moe(w, cfg: Dict, p: str, y: torch.Tensor, pick, wts) -> torch.Tensor:
    """The routed experts, one at a time over the rows that chose them, and
    the shared experts."""
    inter = cfg["moe_intermediate_size"]
    out = swiglu(w, p + "mlp.shared_experts.", y)
    gate_up, down = w[p + "mlp.experts.gate_up_proj"], w[p + "mlp.experts.down_proj"]
    for e in range(gate_up.shape[0]):
        rows, slot = torch.nonzero(pick == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        ex = {"g": gate_up[e, :inter], "u": gate_up[e, inter:], "d": down[e]}
        x = y[rows]
        h = F.silu(mm(x, weight(ex, "g").T)) * mm(x, weight(ex, "u").T)
        out = out.index_add(0, rows, wts[rows, slot][:, None] * mm(h, weight(ex, "d").T))
    return out


def forward(w: Dict[str, torch.Tensor], cfg: Dict, embeds: torch.Tensor,
            routes: Optional[List[torch.Tensor]] = None, positions: Optional[torch.Tensor] = None,
            force: Optional[torch.Tensor] = None, forced: Optional[torch.Tensor] = None,
            deficits: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Hidden states after the final norm, [T, hidden], of embeds [T, hidden]
    at ``positions`` (0..T-1 when None).  ``routes`` collects each MoE
    layer's chosen experts [T, k].  ``force`` [T, MoE layers, k'] holds a
    program's chosen experts at the rows ``forced`` [T] marks (all when
    None); ``deficits`` collects each MoE layer's :func:`deficit` of them
    there."""
    x = embeds.float()
    t = x.shape[0]
    if positions is None:
        positions = torch.arange(t, device=x.device)
    if force is not None and forced is None:
        forced = torch.ones(t, dtype=torch.bool, device=x.device)
    eps = cfg["rms_norm_eps"]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        y = rms_norm(x, w[p + "input_layernorm.weight"], eps)
        x = x + attention(w, cfg, p + "self_attn.", y, positions)
        y = rms_norm(x, w[p + "post_attention_layernorm.weight"], eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + swiglu(w, p + "mlp.", y)
            continue
        j = i - cfg["first_k_dense_replace"]
        mine = None if force is None else force[:, j]
        pick, wts, biased = route(w, cfg, p, y, mine, forced)
        if routes is not None:
            routes.append(pick)
        if deficits is not None and mine is not None:
            deficits.append(deficit(biased[forced], mine[forced], cfg["num_experts_per_tok"]))
        x = x + moe(w, cfg, p, y, pick, wts)
    return rms_norm(x, w["norm.weight"], eps)


def logits(w: Dict[str, torch.Tensor], hidden: torch.Tensor) -> torch.Tensor:
    return mm(hidden, weight(w, "lm_head.weight").T)


def served_logits(w_llm: Dict[str, torch.Tensor], cfg_llm: Dict, prompt: torch.Tensor,
                  positions: torch.Tensor, tokens: Sequence[int], **kw) -> torch.Tensor:
    """[len(tokens) + 1, vocab] logits of the prompt's last position and of
    each served token's (row k predicts ``tokens[k]``; the last, what
    follows them), over the merged prompt's embeddings ``prompt`` [P,
    hidden] at ``positions`` [P] and then the tokens' (the next positions);
    ``kw`` as :func:`forward`.  ``w_llm`` in any dtype, upcast layer by
    layer."""
    with torch.no_grad():
        table = w_llm["embed_tokens.weight"]
        ids = torch.as_tensor(list(tokens), device=table.device, dtype=torch.long)
        seq = torch.cat([prompt.to(table.device).float(), table[ids].float()])
        last = positions[-1:].to(table.device)
        pos = torch.cat([positions.to(table.device), last + 1 + torch.arange(
            len(tokens), device=table.device)])
        hidden = forward(w_llm, cfg_llm, seq, positions=pos, **kw)
        return logits(w_llm, hidden[seq.shape[0] - len(tokens) - 1:])
