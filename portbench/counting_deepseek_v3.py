"""Counts of useful work for a DeepSeek-V3 LLM (latent attention, routed
experts), held against ``counting.py``'s peaks.

* :func:`mla_attention`: the expanded prefill's attention over one row of
  ``length`` valid positions, causal: q . k over the q/k head dim (nope +
  rope, 192) and p . v over v's (128), 2 FLOPs a multiply-add; bytes q, k,
  v and out once, in bf16, and the fp32 log-sum-exp.
* :func:`moe`: the routed experts of the calls that the device tallies
  (``moe.rows``, ``moe.experts_read``) recorded: each (token, choice) pair
  a SwiGLU of the expert width, 6 H I FLOPs; bytes each expert read once a
  call (3 H I weights in bf16) and each pair's activations once (its row
  in, bf16, its weighted output, fp32).  The same work whatever computes
  it.
* :func:`decode_least_seconds`: the pool's useful serving work, as
  ``counting.decode_least_seconds`` at the active parameters: each
  request's front half and the prefill of its own positions; each decode
  step reads the weights outside the routed experts (the head included)
  once, the experts the tallies say its steps read, and every slot's
  valid latent cells (``kv_lora_rank`` + ``qk_rope_head_dim`` a layer);
  a decode token's FLOPs are 2 a weight it uses (its 6 experts, the
  shared ones, the head) and the absorbed attention over its context.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from portbench import counting

BF16 = counting.BF16


def mla_attention(length: int, heads: int, qk_dim: int, v_dim: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of causal attention over one row of ``length`` valid
    positions."""
    pairs = length * (length + 1) / 2
    flops = 2.0 * pairs * heads * (qk_dim + v_dim)
    nbytes = length * heads * (2 * qk_dim + 2 * v_dim) * BF16 + length * heads * 4
    return flops, nbytes


def expert_params(llm: Dict) -> int:
    return 3 * llm["hidden_size"] * llm["moe_intermediate_size"]


def moe(llm: Dict, rows: float, experts_read: float) -> Tuple[float, float]:
    """(FLOPs, bytes) of ``rows`` (token, choice) pairs through their
    experts, ``experts_read`` (layer, expert) weight blocks read."""
    h = llm["hidden_size"]
    flops = 2.0 * rows * expert_params(llm)
    nbytes = experts_read * expert_params(llm) * BF16 + rows * (h * BF16 + h * 4)
    return flops, nbytes


def moe_least_seconds(llm: Dict, tallies: Dict) -> float:
    """The least time of the recorded calls: one-token steps ([0]) and the
    rest ([1]) each against the larger of its bounds."""
    total = 0.0
    for kind in (0, 1):
        rows = sum(sum(layer) for layer in tallies["moe.rows"][kind])
        read = sum(tallies["moe.experts_read"][kind])
        total += counting.least_seconds(*moe(llm, rows, read))
    return total


def dense_params(llm: Dict) -> Dict[str, float]:
    """Weights outside the routed experts, by part: attention, the dense
    layers' SwiGLU, the shared experts with the routers, the head."""
    h, nh, n = llm["hidden_size"], llm["num_attention_heads"], llm["num_hidden_layers"]
    dn, dr, dv, rank = (llm["qk_nope_head_dim"], llm["qk_rope_head_dim"], llm["v_head_dim"],
                        llm["kv_lora_rank"])
    dense = llm["first_k_dense_replace"]
    attn = h * nh * (dn + dr) + h * (rank + dr) + rank * nh * (dn + dv) + nh * dv * h
    shared = 3 * h * llm["moe_intermediate_size"] * llm["n_shared_experts"]
    return {"attn": n * attn, "dense_mlp": dense * 3 * h * llm["intermediate_size"],
            "shared": (n - dense) * (shared + h * llm["n_routed_experts"]),
            "head": h * llm["vocab_size"]}


def latent_cell_bytes(llm: Dict) -> float:
    """Bytes of one position's latent cache over the layers (bf16)."""
    return llm["num_hidden_layers"] * (llm["kv_lora_rank"] + llm["qk_rope_head_dim"]) * BF16


def prefill_flops(llm: Dict, length: int) -> float:
    """Forward FLOPs of the decoder over one row of ``length`` valid
    positions (expanded attention), the last position unembedded."""
    p = dense_params(llm)
    moe_layers = llm["num_hidden_layers"] - llm["first_k_dense_replace"]
    per_pos = 2.0 * (p["attn"] + p["dense_mlp"] + p["shared"]
                     + moe_layers * llm["num_experts_per_tok"] * expert_params(llm))
    att = llm["num_hidden_layers"] * mla_attention(
        length, llm["num_attention_heads"], llm["qk_nope_head_dim"] + llm["qk_rope_head_dim"],
        llm["v_head_dim"])[0]
    return length * per_pos + att + 2.0 * p["head"]


def absorbed_flops(llm: Dict, context: int) -> float:
    """One decode token's attention FLOPs in the absorbed form, all layers:
    q_nope into the latent, scores over ``context`` cells, the latent
    context, and out through the v rows."""
    nh, rank = llm["num_attention_heads"], llm["kv_lora_rank"]
    dn, dr, dv = llm["qk_nope_head_dim"], llm["qk_rope_head_dim"], llm["v_head_dim"]
    per_layer = 2.0 * nh * (dn * rank + context * (rank + dr) + context * rank + rank * dv)
    return llm["num_hidden_layers"] * per_layer


def decode_least_seconds(cfg: Dict, requests: Iterable[Dict], slots: int,
                         step_experts_read: float) -> float:
    """The least time of the pool's useful work for ``requests`` (each with
    ``enc``, ``kept``, ``text`` and ``tokens``), the decode steps reading
    ``step_experts_read`` expert blocks in all."""
    llm = cfg["llm"]
    p = dense_params(llm)
    moe_layers = llm["num_hidden_layers"] - llm["first_k_dense_replace"]
    active = (p["attn"] + p["dense_mlp"] + p["shared"] + p["head"]
              + moe_layers * llm["num_experts_per_tok"] * expert_params(llm))
    cell = latent_cell_bytes(llm)
    total, tokens, dec_f, dec_b = 0.0, 0, 0.0, 0.0
    for r in requests:
        prompt = r["text"] + r["kept"] - 1
        pf = counting.encoder_flops(cfg["encoder"], r["enc"]) + counting.projector_flops(
            cfg, r["kept"]) + prefill_flops(llm, prompt)
        pb = prompt * (llm["hidden_size"] * BF16 + cell)
        total += counting.least_seconds(pf, pb)
        for k in range(1, r["tokens"]):
            ctx = prompt + k
            dec_f += 2.0 * active + absorbed_flops(llm, ctx)
            dec_b += ctx * cell
        tokens += max(r["tokens"] - 1, 0)
    steps = -(-tokens // slots)
    dec_b += steps * sum(p.values()) * BF16 + step_experts_read * expert_params(llm) * BF16
    return total + counting.least_seconds(dec_f, dec_b)
