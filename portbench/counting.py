"""Frozen counts of useful work, and the peaks they are held against.

Started from ``ps_slm_tpu_torch/utils/flops.py`` (its matmul counts and
its multipliers for frozen parts: a frozen encoder with nothing trainable
upstream has no backward; a frozen LLM below a trainable projector takes
activation gradients only, 1x its forward for projections, MLP and
unembedding and 2x for attention's two products; a trainable part 2x), with
two corrections and two additions:

* causal attention counts the scores on and below the diagonal,
  ``L (L + 1) / 2`` pairs, not ``L^2``;
* every count is at the rows' valid positions (the audio span at the
  frames PSD keeps), not at the padded shapes;
* bytes for rooflines and for decoding: each input read once and each
  output written once (bf16, fp32 statistics), the int8 weights once a
  decode step, the valid KV cells of each slot;
* the standalone ASR pass (encoder and CTC head).

The peaks are the NVIDIA H100 SXM's data-sheet figures.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

PEAK_FLOPS = 989e12       # dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12      # HBM3 bytes/s
BF16 = 2


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take for the work."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


# ----------------------------------------------------------------------------
# kernels
# ----------------------------------------------------------------------------

def attention(length: int, heads: int, kv_heads: int, head_dim: int, causal: bool,
              backward: bool = False) -> Tuple[float, float]:
    """(FLOPs, bytes) of softmax attention over one row of ``length`` valid
    positions: QK^T and PV; the backward 2x their FLOPs (the gradients of
    both operands of both products).  Bytes: q, k, v, o (and do, dq, dk, dv
    in the backward), fp32 log-sum-exp a query row and head."""
    pairs = length * (length + 1) / 2 if causal else length * length
    flops = 4.0 * pairs * heads * head_dim
    q = length * heads * head_dim * BF16
    kv = 2 * length * kv_heads * head_dim * BF16
    lse = length * heads * 4
    if backward:
        return 2 * flops, 3 * q + 2 * kv + lse       # read q, o, do, k, v, lse; write dq, dk, dv
    return flops, 2 * q + kv + lse                   # read q, k, v; write o, lse


def norm(rows: int, width: int, backward: bool = False, param_grads: bool = False
         ) -> Tuple[float, float]:
    """(FLOPs, bytes) of a LayerNorm or RMSNorm over ``rows`` x ``width``:
    read x, write y (and fp32 statistics); the backward reads x, dy and
    the statistics and writes dx, with the weight's and bias's gradients
    when the parameters train."""
    flops = 8.0 * rows * width
    act = rows * width * BF16
    if backward:
        return 2 * flops, 3 * act + rows * 8 + (2 * width * BF16 if param_grads else 0)
    return flops, 2 * act + rows * 8 + 2 * width * BF16


# ----------------------------------------------------------------------------
# models
# ----------------------------------------------------------------------------

def encoder_flops(enc: Dict, length: int, ctc_head: bool = True) -> float:
    """Forward matmul FLOPs of the SANM stack (and its CTC head) over one
    row of ``length`` positions (the four queries counted)."""
    d, ff, k = enc["output_size"], enc["linear_units"], enc["kernel_size"]
    n = enc["num_blocks"] + enc["tp_blocks"]
    qkv = 2.0 * length * 3 * d * (enc["input_size"] + (n - 1) * d)
    rest = 2.0 * length * n * (d * d + k * d + 2 * d * ff)
    att = n * attention(length, enc["attention_heads"], enc["attention_heads"],
                        d // enc["attention_heads"], causal=False)[0]
    head = 2.0 * length * d * enc["vocab_size"] if ctc_head else 0.0
    return qkv + rest + att + head


def llm_flops(llm: Dict, length: int, unembed_rows: int) -> Dict[str, float]:
    """Forward matmul FLOPs of the decoder over one row of ``length``
    positions, by part."""
    d, ff, n = llm["hidden_size"], llm["intermediate_size"], llm["num_hidden_layers"]
    d_att = llm["num_attention_heads"] * llm["head_dim"]
    d_kv = llm["num_key_value_heads"] * llm["head_dim"]
    return {"proj": 2.0 * length * n * (2 * d * d_att + 2 * d * d_kv),
            "mlp": 2.0 * length * n * 3 * d * ff,
            "attn": n * attention(length, llm["num_attention_heads"], llm["num_key_value_heads"],
                                  llm["head_dim"], causal=True)[0],
            "unembed": 2.0 * unembed_rows * d * llm["vocab_size"]}


def projector_flops(cfg: Dict, rows: int) -> float:
    v, h, o = cfg["encoder"]["vocab_size"], cfg["projector"]["hidden"], cfg["llm"]["hidden_size"]
    return 2.0 * rows * (v * h + h * o)


def llm_weight_bytes(llm: Dict, bytes_per_weight: float) -> float:
    """The decoder's projections at ``bytes_per_weight``, the tied table and
    the norms in bf16: what one decode step reads."""
    d, ff, n = llm["hidden_size"], llm["intermediate_size"], llm["num_hidden_layers"]
    d_att = llm["num_attention_heads"] * llm["head_dim"]
    d_kv = llm["num_key_value_heads"] * llm["head_dim"]
    proj = n * (2 * d * d_att + 2 * d * d_kv + 3 * d * ff)
    return proj * bytes_per_weight + llm["vocab_size"] * d * BF16 + (2 * n + 1) * d * BF16


def kv_cell_bytes(llm: Dict, bytes_per_value: float = BF16) -> float:
    """Bytes of one position's keys and values over the layers."""
    return (llm["num_hidden_layers"] * 2 * llm["num_key_value_heads"] * llm["head_dim"]
            * bytes_per_value)


# ----------------------------------------------------------------------------
# a training step of the TASU recipes
# ----------------------------------------------------------------------------

def train_step(cfg: Dict, rows: Iterable[Dict], encoder: bool = True) -> Dict[str, Tuple[float, float]]:
    """Useful work of one step, by kind: ``model`` (FLOPs for MFU),
    ``attention`` and ``norm`` ((FLOPs, bytes) of the kernels' calls).
    Each row gives ``enc`` (encoder positions, queries counted; 0 without
    an encoder), ``kept`` (the audio span's frames), ``text`` (its valid
    tokens, the ``<speech>`` one counted) and ``labels``."""
    enc, llm = cfg["encoder"], cfg["llm"]
    v, d = enc["vocab_size"], llm["hidden_size"]
    h, kvh, hd = llm["num_attention_heads"], llm["num_key_value_heads"], llm["head_dim"]
    n_llm = llm["num_hidden_layers"]
    n_enc = enc["num_blocks"] + enc["tp_blocks"]
    model = att_f = att_b = norm_f = norm_b = 0.0
    for r in rows:
        merged = r["text"] + r["kept"] - 1
        if encoder and r["enc"]:
            model += encoder_flops(enc, r["enc"])
            f, b = attention(r["enc"], enc["attention_heads"], enc["attention_heads"],
                             enc["output_size"] // enc["attention_heads"], causal=False)
            att_f, att_b = att_f + n_enc * f, att_b + n_enc * b
            f, b = norm(r["enc"], enc["input_size"])
            norm_f, norm_b = norm_f + f, norm_b + b
            f, b = norm(r["enc"], enc["output_size"])
            norm_f, norm_b = norm_f + (2 * n_enc + 1) * f, norm_b + (2 * n_enc + 1) * b
        model += 3 * projector_flops(cfg, r["kept"])
        for back, grads in ((False, False), (True, True)):
            f, b = norm(r["kept"], v, back, grads)
            norm_f, norm_b = norm_f + f, norm_b + b
        lf = llm_flops(llm, merged, r["labels"])
        model += sum(lf.values()) + lf["proj"] + lf["mlp"] + lf["unembed"] + 2 * lf["attn"]
        for back in (False, True):
            f, b = attention(merged, h, kvh, hd, causal=True, backward=back)
            att_f, att_b = att_f + n_llm * f, att_b + n_llm * b
            f, b = norm(merged, d, back)
            norm_f, norm_b = norm_f + (2 * n_llm + 1) * f, norm_b + (2 * n_llm + 1) * b
    return {"model": (model, 0.0), "attention": (att_f, att_b), "norm": (norm_f, norm_b)}


# ----------------------------------------------------------------------------
# the serving pool
# ----------------------------------------------------------------------------

def decode_least_seconds(cfg: Dict, requests: Iterable[Dict], slots: int,
                         weight_bytes_per_param: float = 1.0) -> float:
    """The least time of the pool's useful work for ``requests``, each with
    ``enc``, ``kept``, ``text`` (its prompt's valid tokens) and ``tokens``
    (served): each refill's front half and the prefill of its own
    positions; the decode steps of every served token after the first,
    ``slots`` to a step, each step reading the weights once and every
    slot its valid KV cells."""
    llm = cfg["llm"]
    cell = kv_cell_bytes(llm)
    params = (llm_weight_bytes(llm, 1.0) - llm["vocab_size"] * llm["hidden_size"] * BF16
              - (2 * llm["num_hidden_layers"] + 1) * llm["hidden_size"] * BF16)
    per_token = 2.0 * params + 2.0 * llm["hidden_size"] * llm["vocab_size"]
    d_att = llm["num_attention_heads"] * llm["head_dim"]
    total, tokens, dec_f, dec_b = 0.0, 0, 0.0, 0.0
    for r in requests:
        prompt = r["text"] + r["kept"] - 1
        pf = encoder_flops(cfg["encoder"], r["enc"]) + projector_flops(cfg, r["kept"])
        pf += sum(llm_flops(llm, prompt, 1).values())
        pb = prompt * (llm["hidden_size"] * BF16 + cell)
        total += least_seconds(pf, pb)
        for k in range(1, r["tokens"]):
            ctx = prompt + k
            dec_f += per_token + 4.0 * ctx * d_att * llm["num_hidden_layers"]
            dec_b += ctx * cell
        tokens += max(r["tokens"] - 1, 0)
    steps = -(-tokens // slots)
    dec_b += steps * llm_weight_bytes(llm, weight_bytes_per_param)
    return total + least_seconds(dec_f, dec_b)


def asr_flops(enc: Dict, lengths: Iterable[int]) -> float:
    """Forward FLOPs of the standalone ASR pass: encoder and CTC head over
    each utterance's positions (queries counted)."""
    return sum(encoder_flops(enc, n) for n in lengths)
