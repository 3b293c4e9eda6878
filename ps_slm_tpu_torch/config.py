"""The configuration fields the port's serving and training paths read.

A small copy of ``ps_slm_tpu/config.py``'s ``ModelConfig`` and
``TrainConfig``: same names, same defaults, only the fields this package
uses.  The rest of the JAX package's configuration (data, logging, the
CLI override parser) comes with the slices that need it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class ModelConfig:
    llm_path: str = ""
    llm_dim: int = 1536
    encoder_path: Optional[str] = None
    encoder_dim: int = 512
    encoder_projector: str = "linear-silu"
    encoder_projector_ds_rate: int = 1
    ctc_linear: Optional[str] = None
    # config overrides for random-init models (None = the tiny test config)
    llm_config_overrides: Optional[dict] = None
    encoder_config_overrides: Optional[dict] = None


@dataclass
class TrainConfig:
    seed: int = 42
    # optimizer and schedule (AdamW + warmup-cosine, conf/ds_config.json)
    lr: float = 5e-5
    warmup_steps: int = 200
    total_steps: int = 15000
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-6
    weight_decay: float = 0.0
    gradient_accumulation_steps: int = 1
    remat: bool = False
    # TASU algorithm switches
    do_psd: bool = False
    ctc_posterior: bool = False
    voca_trans: bool = False
    gt_emb: bool = False
    gt_emb_noise: bool = False
    cross_attn: bool = False
    # text-only noise knobs (the JAX package's CPS noise defaults)
    drop_prob: float = 0.05
    insert_prob: float = 0.0
    smooth_low: float = 0.0
    smooth_high: float = 0.1
    use_peft: bool = False
    quantization: bool = False
    # freezing
    freeze_llm: bool = False
    freeze_encoder: bool = False
    freeze_projector: bool = False


# the shapes of the benchmarked training step (bench.py): utterances per
# batch, LFR frames per utterance, text tokens per row
BENCH_BATCH = 5
BENCH_FRAMES = 512
BENCH_TEXT_LEN = 32

# published widths, as config overrides for random-init models
SENSEVOICE_SMALL = dict(
    input_size=560, output_size=512, attention_heads=4, linear_units=2048,
    num_blocks=50, tp_blocks=20, kernel_size=11, vocab_size=25055,
)
QWEN25_1_5B = dict(
    vocab_size=151936, hidden_size=1536, intermediate_size=8960,
    num_hidden_layers=28, num_attention_heads=12, num_key_value_heads=2,
    head_dim=128, rope_theta=1e6,
)


def half_audio_configs(enc_overrides=None, llm_overrides=None, seed: int = 42):
    """(TrainConfig, ModelConfig) of the published audio-TASU recipe
    (``half_audio``: CTC posterior + PSD + linear-silu, encoder and LLM
    frozen) at SenseVoiceSmall + Qwen2.5-1.5B widths, random init; the
    overrides cut depth."""
    return _published(enc_overrides, llm_overrides, TrainConfig(
        seed=seed, ctc_posterior=True, do_psd=True, freeze_llm=True, freeze_encoder=True,
    ))


def text_only_configs(enc_overrides=None, llm_overrides=None, seed: int = 42):
    """(TrainConfig, ModelConfig) of the paper's text-only TASU recipe
    (``scripts/finetune_text_only.sh``: the CTC posterior simulated from
    the transcript with CPS noise, ``gt_emb`` + ``gt_emb_noise``, PSD
    flag set but unused on that branch, linear-silu, encoder and LLM
    frozen, lr 5e-5 / warmup 200 / 15 000 steps) at the same widths."""
    return _published(enc_overrides, llm_overrides, TrainConfig(
        seed=seed, ctc_posterior=True, voca_trans=False, gt_emb=True, gt_emb_noise=True,
        do_psd=True, freeze_llm=True, freeze_encoder=True,
    ))


def _published(enc_overrides, llm_overrides, tc: TrainConfig):
    enc = dict(SENSEVOICE_SMALL, **(enc_overrides or {}))
    llm = dict(QWEN25_1_5B, **(llm_overrides or {}))
    mc = ModelConfig(
        llm_dim=llm["hidden_size"], encoder_dim=enc["vocab_size"],
        llm_config_overrides=llm, encoder_config_overrides=enc,
    )
    return tc, mc
