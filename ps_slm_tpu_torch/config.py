"""The configuration of the port's serving, training and decode paths.

A copy of ``ps_slm_tpu/config.py`` with the same names and defaults:
``FbankConfig``, ``DataConfig``, ``LogConfig`` and ``RunConfig`` whole;
``PeftConfig``, ``ModelConfig`` and ``TrainConfig`` whole; and the ``[++]section.key=value``
override parser (``parse_cli``) that the CLIs take, and :func:`dump`, which
writes a run's resolved config.  Fields the JAX package itself never reads
(``model_name``, ``llm_name``, ``gamma``, ...) are carried, inert, so the
same overrides parse; an override that names an unknown key raises
``KeyError``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, List, Optional


@dataclass
class PeftConfig:
    """Adapter settings of ``use_peft`` (models/lora.py)."""

    peft_method: str = "lora"             # "lora" | "prefix" | "llama_adapter"
    r: int = 64
    lora_alpha: int = 16
    target_modules: List[str] = field(
        default_factory=lambda: [
            "q_proj", "k_proj", "v_proj", "o_proj",
            "up_proj", "gate_proj", "down_proj",
        ]
    )
    bias: str = "none"
    task_type: str = "CAUSAL_LM"
    lora_dropout: float = 0.05
    inference_mode: bool = False
    num_virtual_tokens: int = 30          # prefix tuning
    # llama-adapter: the adaption prompt's length, and how many of the top
    # decoder layers carry one
    adapter_len: int = 10
    adapter_layers: int = 30


@dataclass
class FbankConfig:
    """Kaldi-convention fbank front end, LFR stacking and global CMVN."""

    num_mel_bins: int = 80
    frame_length: int = 25          # ms
    frame_shift: int = 10           # ms
    dither: float = 0.001           # training only
    window_type: str = "hamming"
    use_energy: bool = False
    low_freq: int = 0
    high_freq: int = 8000
    htk_compat: bool = True
    sample_rate: int = 16000
    # LFR stacking (funasr WavFrontend defaults: m=7 stack, n=6 shift -> 560-dim)
    lfr_m: int = 7
    lfr_n: int = 6
    cmvn_path: Optional[str] = None  # am.mvn global CMVN stats
    # SpecAugment on the LFR features during training (default off)
    specaug: bool = False
    specaug_t_masks: int = 2
    specaug_t_width: int = 50
    specaug_f_masks: int = 2
    specaug_f_width: int = 10


@dataclass
class ModelConfig:
    factory: str = "tasu"           # registry name (ps_slm_tpu_torch.registry)
    llm_name: str = "Qwen2.5-1.5B-Instruct"   # inert
    llm_path: str = ""
    llm_type: str = "decoder_only"            # inert
    llm_dim: int = 1536
    encoder_name: str = "sensevoice"          # inert
    encoder_path: Optional[str] = None
    encoder_dim: int = 512
    encoder_projector: str = "linear-silu"
    encoder_projector_ds_rate: int = 1
    ctc_linear: Optional[str] = None      # a pretrained CTC head into simple_linear
    qformer_layers: int = 8
    qformer_heads: int = 12
    query_len: int = 64
    ca_heads: int = 8                     # the cross-attention projector's heads
    # encoder BPE model directory when it does not live next to the
    # encoder weights (default: encoder_path)
    encoder_bpe_path: Optional[str] = None
    # config overrides for random-init models (None = the tiny test config)
    llm_config_overrides: Optional[dict] = None
    encoder_config_overrides: Optional[dict] = None


@dataclass
class TrainConfig:
    model_name: str = "asr_model"         # inert
    run_validation: bool = True
    batch_size_training: Optional[int] = None   # the "padding" strategy's batch
    batching_strategy: str = "dynamic"    # "dynamic" token budget | "padding"
    context_length: int = 4096            # inert
    gradient_accumulation_steps: int = 1  # optax.MultiSteps semantics
    num_epochs: int = 3
    num_workers_dataloader: int = 1       # inert
    # optimizer and schedule (AdamW + warmup-cosine, conf/ds_config.json)
    warmup_steps: int = 200
    total_steps: int = 15000
    validation_interval: int = 1000
    lr: float = 5e-5
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-6
    weight_decay: float = 0.0
    gamma: float = 0.85                   # inert
    seed: int = 42
    mixed_precision: bool = True          # bf16 compute, fp32 norms/softmax
    val_batch_size: Optional[int] = None  # the "padding" strategy's eval batch
    # TASU algorithm switches
    do_psd: bool = False
    ctc_posterior: bool = False
    voca_trans: bool = False
    use_peft: bool = False                # adapters by peft_config (models/lora.py)
    use_emb: bool = False                 # embed_tokens trains under PEFT
    gt_emb: bool = False
    gt_emb_noise: bool = False
    top1_emb: bool = False                # voca_trans: the top-1 token's embedding
    cross_attn: bool = False
    gaussian_sim: bool = False            # inert
    # text-only noise knobs (the JAX package's CPS noise defaults)
    drop_prob: float = 0.05
    insert_prob: float = 0.0
    smooth_low: float = 0.0
    smooth_high: float = 0.1
    # the voca_trans PSD's blank id in training; generate takes the
    # encoder's (the reference's two paths differ, mirrored)
    voca_trans_blank_id: int = 151643
    # freezing
    freeze_llm: bool = False
    freeze_encoder: bool = False
    freeze_projector: bool = False
    freeze_layers: bool = False           # inert
    num_freeze_layers: int = 1            # inert
    # run
    peft_config: PeftConfig = field(default_factory=PeftConfig)
    output_dir: str = "out"
    quantization: bool = False            # weight-only LLM (models/quantization.py)
    quant_bits: int = 8                   # 8 (per output channel) or 4 (group-wise)
    q4_group_size: int = 128              # contraction-group size of the int4 scales
    save_model: bool = True               # step_N/ on a new best eval loss
    save_last: bool = False               # last/ at the end of training
    resume_from: Optional[str] = None     # a train-state directory (step_N/state)
    device: Optional[int] = 0             # inert
    mesh_shape: Optional[dict] = None     # e.g. {"data": 4, "fsdp": 2} (+ "tensor"/"pipe"); None = all "data"
    fsdp_min_size: int = 2 ** 16          # only shard params at least this big
    pp_microbatches: int = 0              # GPipe microbatches when mesh has pipe>1 (0 = 2 x stages)
    remat: bool = False                   # activation checkpointing of the blocks
    # decode
    max_new_tokens: int = 200
    num_beams: int = 4
    do_sample: bool = False
    min_length: int = 1
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    length_penalty: float = 1.0
    temperature: float = 1.0
    kv_cache_bits: int = 16
    # serving pools (inference/continuous*.py) and draft-verified decoding
    # (inference/speculative.py)
    continuous_batching: bool = False
    decode_slots: int = 8
    decode_sync_every: int = 8
    stream_partials: bool = False
    # cli/serve.py's route: "auto" serves the first route_probe completions
    # through the slot pool, then static batches (inference/static_serve.py)
    # while the median completion is under route_static_below tokens, and
    # measured rates decide after that (inference/routing.py); "pool" /
    # "static" force one.  Streaming and speculation always take the pool.
    serve_route: str = "auto"
    route_probe: int = 16
    route_static_below: int = 32
    speculative_ctc: bool = False
    spec_window: int = 8


@dataclass
class DataConfig:
    factory: str = "multitask"            # registry name (ps_slm_tpu_torch.registry)
    dataset: str = "multitask_dataset"
    encoder: str = "sensevoice"
    encoder_path: Optional[str] = None
    max_audio_length: int = 30            # seconds; utterances outside 0.1-30 s drop
    train_max_frame_length: int = 1500
    ds_rate: int = 8
    eval_max_frame_length: int = 2000
    multitask_prompt_path: str = "conf/multiprompt.jsonl"
    prompt_style: str = "<|im_start|>user\n{}<speech><|im_end|>\n<|im_start|>assistant\n"
    append_info_tasks: List[str] = field(default_factory=lambda: ["hotword"])
    train_scp_file_path: str = ""
    dev_scp_file_path: str = ""
    test_scp_file_path: str = ""
    train_split: str = "train"
    dev_split: str = "dev"
    test_split: str = "test"
    inference_mode: bool = False
    lower: bool = False
    fix_length_audio: int = -1
    fbank: FbankConfig = field(default_factory=FbankConfig)
    normalize: bool = False
    # padded lengths are bucketed: LFR frames to a multiple of
    # feature_bucket, tokens to a multiple of token_bucket
    feature_bucket: int = 128
    token_bucket: int = 32
    # host -> device waveform wire format: "int16" (half the bytes, exact
    # for 16-bit PCM) or "float32"
    waveform_dtype: str = "int16"


@dataclass
class LogConfig:
    use_wandb: bool = False
    wandb_dir: str = "tmp/wandb"
    wandb_entity_name: str = "project_name"
    wandb_project_name: str = "project_name"
    wandb_exp_name: str = "exp_name"
    log_file: str = "tmp/train.log"
    log_interval: int = 5
    profile_dir: Optional[str] = None


@dataclass
class RunConfig:
    model_config: ModelConfig = field(default_factory=ModelConfig)
    train_config: TrainConfig = field(default_factory=TrainConfig)
    dataset_config: DataConfig = field(default_factory=DataConfig)
    log_config: LogConfig = field(default_factory=LogConfig)
    ckpt_path: Optional[str] = None
    peft_ckpt: Optional[str] = None
    decode_log: str = "decode"
    debug: bool = False


# ----------------------------------------------------------------------------
# CLI overrides: ``++train_config.lr=1e-4`` / ``train_config.lr=1e-4``
# ----------------------------------------------------------------------------

def _coerce(value: str, current: Any) -> Any:
    """Coerce a CLI string to the type of the current field value."""
    if isinstance(current, bool) or value.lower() in ("true", "false"):
        return value.lower() == "true"
    if value.lower() in ("none", "null"):
        return None
    if isinstance(current, int) and not isinstance(current, bool):
        try:
            return int(value)
        except ValueError:
            return float(value)
    if isinstance(current, float):
        return float(value)
    if value and (
        isinstance(current, (list, dict))
        or (value[0] in "[{" and value[-1] in "]}")
    ):
        return json.loads(value)
    # ints/floats for untyped (None-default) fields
    for caster in (int, float):
        try:
            return caster(value)
        except ValueError:
            pass
    return value


def apply_override(cfg: Any, dotted_key: str, value: str) -> None:
    """Set ``a.b.c=value`` on a nested dataclass tree (in place)."""
    parts = dotted_key.split(".")
    obj = cfg
    for p in parts[:-1]:
        if not hasattr(obj, p):
            raise KeyError(f"unknown config section: {dotted_key!r} (no {p!r})")
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise KeyError(f"unknown config key: {dotted_key!r}")
    setattr(obj, leaf, _coerce(value, getattr(obj, leaf)))


def parse_cli(argv: List[str], cfg: Optional[RunConfig] = None) -> RunConfig:
    """Parse ``[++]key.path=value`` overrides into a RunConfig; a bare
    ``--config foo.json`` (or ``-c``) loads a JSON config first, and
    ``--local_rank*`` (launcher compatibility) is ignored."""
    cfg = cfg or RunConfig()
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg in ("--config", "-c"):
            i += 1
            with open(argv[i]) as f:
                merge_dict(cfg, json.load(f))
        elif "=" in arg:
            key, _, value = arg.partition("=")
            key = key.lstrip("+").lstrip("-")
            apply_override(cfg, key, value)
        elif arg.startswith("--local_rank"):
            pass
        else:
            raise SystemExit(f"unrecognized argument: {arg!r}")
        i += 1
    return cfg


def merge_dict(cfg: Any, overrides: dict) -> Any:
    """Recursively merge a plain dict into a dataclass tree."""
    for k, v in overrides.items():
        if not hasattr(cfg, k):
            raise KeyError(f"unknown config key {k!r} on {type(cfg).__name__}")
        cur = getattr(cfg, k)
        if is_dataclass(cur) and isinstance(v, dict):
            merge_dict(cur, v)
        else:
            setattr(cfg, k, v)
    return cfg


def to_dict(cfg: Any) -> Any:
    """Dataclass tree -> plain dict."""
    if is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def dump(cfg: Any, path: str) -> None:
    """Write ``cfg`` as indented JSON (a run's ``resolved_config.json``)."""
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2, default=str)


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
