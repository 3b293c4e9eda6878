"""Analytic model FLOPs of the audio-TASU training step, for MFU.

A copy of ``ps_slm_tpu/utils/flops.py`` (the port imports nothing of the
JAX package).  It counts *useful* matmul work at the step's static shapes:
attention, projections, MLP and the CE unembedding; the PSD reductions
count as nothing.  Backward multipliers follow the freeze flags:

  * a frozen encoder with nothing trainable upstream: no backward;
  * a frozen LLM below a trainable projector: activation gradients only,
    1x forward for projections, MLP and unembedding, 2x for the
    attention-internal matmuls (both operands of QK^T and PV carry
    gradients);
  * trainable components: activation and weight gradients, 2x forward.

The peak is the NVIDIA H100 SXM's published dense bf16 tensor-core rate.
"""

from __future__ import annotations

from typing import Dict, Optional

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak, FLOP/s
H100_BF16_PEAK_FLOPS = 989e12


def qwen2_matmul_flops(
    cfg, seq: int, batch: int, n_unembed_rows: int = 0,
) -> Dict[str, float]:
    """Forward matmul FLOPs for a [batch, seq] Qwen2 pass.

    ``n_unembed_rows``: per-sample rows actually unembedded (gathered CE
    unembeds only labeled rows, ``ops/ce_loss.py``; full-logit paths pass
    ``seq``).  Attention counts the full [S, S] score matmuls (causal
    masking halves the useful scores; the count keeps the convention of
    the JAX package's table, so the two MFUs stay comparable).
    """
    d = cfg.hidden_size
    d_att = cfg.num_attention_heads * cfg.head_dim
    d_kv = cfg.num_key_value_heads * cfg.head_dim
    ff = cfg.intermediate_size
    n = cfg.num_hidden_layers
    tokens = batch * seq

    proj = 2.0 * tokens * n * (d * d_att + 2 * d * d_kv + d_att * d)
    mlp = 2.0 * tokens * n * (3 * d * ff)
    # QK^T and PV: per token, heads x seq x head_dim MACs each
    attn = 2.0 * tokens * n * (2 * seq * d_att)
    unembed = 2.0 * batch * n_unembed_rows * d * cfg.vocab_size
    return {
        "proj": proj, "mlp": mlp, "attn": attn, "unembed": unembed,
        "total": proj + mlp + attn + unembed,
    }


def sensevoice_matmul_flops(cfg, frames: int, batch: int) -> Dict[str, float]:
    """Forward matmul FLOPs for the SANM encoder stack + CTC head."""
    d = cfg.output_size
    ff = cfg.linear_units
    n_layers = cfg.num_blocks + cfg.tp_blocks
    tokens = batch * frames

    # encoders0 takes input_size; every other block d -> 3d
    qkv = 2.0 * tokens * 3 * d * (
        cfg.input_size + (n_layers - 1) * d
    )
    out = 2.0 * tokens * n_layers * d * d
    fsmn = 2.0 * tokens * n_layers * cfg.kernel_size * d
    ffn = 2.0 * tokens * n_layers * 2 * d * ff
    attn = 2.0 * tokens * n_layers * 2 * frames * d
    ctc = 2.0 * tokens * d * cfg.vocab_size
    total = qkv + out + fsmn + ffn + attn + ctc
    return {
        "qkv": qkv, "out": out, "fsmn": fsmn, "ffn": ffn, "attn": attn,
        "ctc_head": ctc, "total": total,
    }


def projector_matmul_flops(
    model_cfg, frames: int, batch: int,
) -> float:
    """Forward matmul FLOPs for the projector (linear-silu / linear
    shapes; other projectors are the same order of magnitude)."""
    k = max(model_cfg.encoder_projector_ds_rate, 1)
    tokens = batch * (frames // k)
    d_in = model_cfg.encoder_dim * k
    hidden = 2048  # EncoderProjector hidden (reference projector.py:29-50,129-151)
    return 2.0 * tokens * (d_in * hidden + hidden * model_cfg.llm_dim)


def tasu_step_flops(
    llm_cfg,
    enc_cfg,
    model_cfg,
    *,
    batch: int,
    frames: int,
    text_len: int,
    n_unembed_rows: Optional[int] = None,
    freeze_llm: bool = True,
    freeze_encoder: bool = True,
    freeze_projector: bool = False,
    use_peft: bool = False,
) -> Dict[str, float]:
    """Total fwd+bwd useful matmul FLOPs for one audio-TASU train step.

    Mirrors the static shapes of ``models/tasu.py::forward``: the audio
    span entering the merge is the projector's OUTPUT length
    frames // encoder_projector_ds_rate (frame-concat downsampling,
    models/projector.py), so merged LLM sequence = text_len + A - 1
    (``ops/merge.py`` OUT = S + A - 1); gathered CE unembeds
    ceil(text_len/8)*8 rows when text_len <= (T-1)/2.
    """
    a_len = frames // max(model_cfg.encoder_projector_ds_rate, 1)
    merged_seq = text_len + a_len - 1
    if n_unembed_rows is None:
        if text_len <= (merged_seq - 1) // 2:
            n_unembed_rows = min(-(-text_len // 8) * 8, merged_seq - 1)
        else:
            n_unembed_rows = merged_seq

    enc = sensevoice_matmul_flops(enc_cfg, frames, batch)
    proj_fwd = projector_matmul_flops(model_cfg, frames, batch)
    llm = qwen2_matmul_flops(
        llm_cfg, merged_seq, batch, n_unembed_rows=n_unembed_rows
    )

    # backward multipliers (see module docstring)
    enc_bwd = 0.0 if freeze_encoder else 2.0 * enc["total"]
    proj_bwd = 0.0 if freeze_projector else 2.0 * proj_fwd
    if freeze_llm:
        # dgrad only: 1x projections/mlp/unembed, 2x attention interior.
        # LoRA (use_peft) keeps the same multipliers: the frozen base still
        # gets no wgrads, and the adapter wgrads are the negligible
        # low-rank matmuls (module docstring)
        llm_bwd = llm["proj"] + llm["mlp"] + llm["unembed"] + 2 * llm["attn"]
    else:
        llm_bwd = 2.0 * llm["total"]

    fwd = enc["total"] + proj_fwd + llm["total"]
    bwd = enc_bwd + proj_bwd + llm_bwd
    return {
        "encoder_fwd": enc["total"],
        "projector_fwd": proj_fwd,
        "llm_fwd": llm["total"],
        "fwd": fwd,
        "bwd": bwd,
        "total": fwd + bwd,
    }


# dense bf16 tensor-core peak TFLOP/s by device-name substring (NVIDIA data
# sheets); the H100 SXM's is H100_BF16_PEAK_FLOPS, the PCIe card's 756
_PEAK_TFLOPS = (
    ("H100 PCIe", 756.0),
    ("H100", H100_BF16_PEAK_FLOPS / 1e12),
)


def device_peak_tflops(device=None) -> Optional[float]:
    """The dense bf16 peak of a CUDA device (default: the current one) in
    TFLOP/s, or None for the CPU or a card not in the table."""
    import torch

    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for sub, peak in _PEAK_TFLOPS:
        if sub in name:
            return peak
    return None
