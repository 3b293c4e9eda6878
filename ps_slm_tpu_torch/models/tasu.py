"""TASU composite model: SenseVoice encoder + projector + Qwen2 LLM.

Counterpart of ``ps_slm_tpu/models/tasu.py``, every branch of its
forward.  Audio TASU (``half_audio``: ``ctc_posterior=True``,
``do_psd=True``, the ``linear-silu`` projector):

  1. query prepend + encoder + fp32 CTC softmax + drop the 4 query frames
  2. PSD over the posterior (when ``do_psd``)
  3. projector
  4. merge into the LLM's token embeddings
  5. (training, :func:`forward`) the LLM and the causal CE on the merged
     labels; :func:`trainable_mask` applies the freeze flags

Text-only TASU (``gt_emb``, the paper's recipe) replaces steps 1-2 with a
posterior simulated from the transcript ids in the batch (``gt_ids``,
``gt_lens``): CPS noise in training when ``gt_emb_noise``
(``ops/pseudo_posterior.py``), the clean one-hot when generating; the
encoder does not run.

Audio enters as LFR features (``input_features``) or as waveforms
(``waveform``, int16 or fp32, and ``waveform_length``), which the front
end (``ops/fbank.py``: fbank, LFR, the model's CMVN; dither and
SpecAugment in training) turns into features on the device.

``model.remat`` checkpoints each transformer block of the LLM and the
encoder while gradients are recorded (``torch.utils.checkpoint``, no
saved residuals, as the JAX ``jax.checkpoint`` of the block body): the
backward recomputes each block's forward.

The other branches (:func:`compute_audio_embeds`):

* the cross-attention projector (``cross_attn``, or the projector named
  ``cross-attention``) over the posterior, at the encoder's frame rate;
* voca_trans (LegoSLM): the projector maps the encoder's output to
  LLM-vocabulary logits, PSD pools them (blank ``voca_trans_blank_id`` in
  training, the encoder's blank id when generating, as the reference's
  two paths differ), the last column drops, and the softmax mixes the
  LLM's embeddings (``top1_emb``: the argmax token's embedding);
* the raw-feature baseline (``ctc_posterior=False``): the projector over
  the encoder's output, PSD-pooled by the posterior when ``do_psd``.

Under a ``tensor`` mesh axis the LLM's table is sharded on its vocabulary
rows (``Qwen2Model.vocab``): voca_trans looks its top-1 ids up and mixes
this rank's rows by the matching columns of the softmax, summed over the
ranks (``parallel.tensor``), and the cross-attention projector attends
over the table gathered whole once a forward.

The q-former gives ``query_len`` embeddings a row, and its span in the
merge is ``query_len`` long, attending to the row's valid frames only; the
JAX package takes the frame count as the span and attends to the padding
too, which agrees only where every row has ``query_len`` frames (ROADMAP.md
queue 3, faults of the reference).

:func:`model_factory` loads an HF Qwen2 directory (``llm_path``), a funasr
SenseVoiceSmall directory (``encoder_path``) and a pretrained CTC head
into the simple_linear projector (``ctc_linear``), and random-initialises
the rest from a seeded ``torch.Generator`` (``convert.from_jax_params``
maps a JAX parameter tree).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from ps_slm_tpu_torch._build import resolve_device
from ps_slm_tpu_torch.config import FbankConfig
from ps_slm_tpu_torch.models import deepseek_v3, qwen2
from ps_slm_tpu_torch.models import projector as proj
from ps_slm_tpu_torch.models.lora import ADAPTER_LEAVES, add_peft
from ps_slm_tpu_torch.models.quantization import quantize_llm
from ps_slm_tpu_torch.models.qwen2 import Qwen2Config, Qwen2Model
from ps_slm_tpu_torch.models.sensevoice import SenseVoiceConfig, SenseVoiceEncoder
from ps_slm_tpu_torch.ops.ce_loss import chunked_ce_loss, full_ce_loss, gathered_ce_loss
from ps_slm_tpu_torch.ops.fbank import FrontendDraws, frontend
from ps_slm_tpu_torch.ops.merge import Merged, merge_audio_text
from ps_slm_tpu_torch.ops.pseudo_posterior import (
    NoiseDraws, noise_draws, pseudo_posterior, pseudo_posterior_noise,
)
from ps_slm_tpu_torch.ops.psd import psd
from ps_slm_tpu_torch.parallel.tensor import gather_rows, vocab_embed, vocab_mix
from ps_slm_tpu_torch.registry import register_model
from ps_slm_tpu_torch.training.checkpoint import load_ctc_linear, load_funasr_encoder
from ps_slm_tpu_torch.utils.profiler import span

IGNORE_ID = -100
QUERY_IDS = (0, 1, 2, 2)   # language, event, emotion, textnorm
# above this many bytes of fp32 logits the full-logit CE goes chunked
CHUNKED_CE_BYTES = 3 * 2 ** 29   # 1.5 GB


@dataclass(frozen=True)
class TasuFlags:
    """Static algorithm switches (the JAX ``TasuFlags``)."""

    ctc_posterior: bool = False
    voca_trans: bool = False
    gt_emb: bool = False
    gt_emb_noise: bool = False
    do_psd: bool = False
    top1_emb: bool = False
    cross_attn: bool = False
    drop_prob: float = 0.05
    insert_prob: float = 0.0
    smooth_low: float = 0.0
    smooth_high: float = 0.1
    voca_trans_blank_id: int = 151643
    blank_threshold: float = 0.9

    @property
    def needs_encoder(self) -> bool:
        """Text-only TASU never reads the encoder's output."""
        return not (self.ctc_posterior and not self.voca_trans and self.gt_emb)

    @staticmethod
    def from_train_config(tc, model_config=None) -> "TasuFlags":
        cross = bool(tc.cross_attn) or (
            model_config is not None
            and model_config.encoder_projector == "cross-attention"
        )
        return TasuFlags(
            ctc_posterior=tc.ctc_posterior, voca_trans=tc.voca_trans,
            gt_emb=tc.gt_emb, gt_emb_noise=tc.gt_emb_noise, do_psd=tc.do_psd,
            top1_emb=tc.top1_emb, cross_attn=cross, drop_prob=tc.drop_prob,
            insert_prob=tc.insert_prob, smooth_low=tc.smooth_low,
            smooth_high=tc.smooth_high, voca_trans_blank_id=tc.voca_trans_blank_id,
        )


class TasuModel(nn.Module):
    def __init__(
        self, enc_cfg: SenseVoiceConfig, llm_cfg: Qwen2Config, model_cfg,
        flags: TasuFlags, speech_token_id: int = 0, pad_token_id: int = 0,
    ):
        super().__init__()
        self.enc_cfg, self.llm_cfg, self.model_cfg = enc_cfg, llm_cfg, model_cfg
        self.flags = flags
        self.speech_token_id = speech_token_id
        self.pad_token_id = pad_token_id
        self.encoder = SenseVoiceEncoder(enc_cfg)
        self.projector = proj.build_projector(model_cfg)
        self.llm = build_llm(llm_cfg)
        self.fbank_cfg = FbankConfig()
        # the global CMVN of the waveform front end (``cmvn``), as buffers
        # so that they follow the model's device
        self.register_buffer("cmvn_neg_mean", None, persistent=False)
        self.register_buffer("cmvn_inv_std", None, persistent=False)

    @property
    def cmvn(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """(neg_mean, inv_stddev) fp32 on the model's device, or None."""
        if self.cmvn_neg_mean is None:
            return None
        return self.cmvn_neg_mean, self.cmvn_inv_std

    @cmvn.setter
    def cmvn(self, value) -> None:
        """Take a (neg_mean, inv_stddev) pair of arrays or tensors (as
        ``ops.fbank.load_cmvn`` gives), or None."""
        dev = self.llm.embed_tokens.weight.device
        if value is None:
            self.cmvn_neg_mean = self.cmvn_inv_std = None
            return
        self.cmvn_neg_mean, self.cmvn_inv_std = (
            torch.as_tensor(v, dtype=torch.float32).to(dev) for v in value)

    @property
    def mesh(self):
        """The process's place on the mesh (``parallel.mesh.Parallel``, set
        by ``shard_params``) or None: one process."""
        return self.llm.mesh

    @mesh.setter
    def mesh(self, value) -> None:
        self.llm.mesh = value

    @property
    def pp_microbatches(self) -> int:
        return self.llm.pp_microbatches

    @pp_microbatches.setter
    def pp_microbatches(self, value: int) -> None:
        self.llm.pp_microbatches = int(value)

    def forward(self, batch: Dict[str, torch.Tensor], **kw):
        """The training forward (module-level :func:`forward`) as the
        model's call, so that FSDP2 gathers the leaves it keeps at the
        model's level (the embedding table, the CTC head) around it."""
        return forward(self, batch, **kw)

    @property
    def remat(self) -> bool:
        return self.llm.remat

    @remat.setter
    def remat(self, value: bool) -> None:
        self.llm.remat = self.encoder.remat = bool(value)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.llm.init_weights(generator)
        self.encoder.init_weights(generator)
        self.projector.init_weights(generator)


def encode_speech(
    encoder: SenseVoiceEncoder,
    input_features: torch.Tensor,        # [B, A, input_size]
    input_feature_length: torch.Tensor,  # [B]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Query prepend -> encoder -> fp32 CTC softmax -> drop the 4 query
    frames.  Returns (encoder_out [B,A,D], ctc posterior [B,A,V] in the
    compute dtype, lens [B])."""
    b = input_features.shape[0]
    queries = encoder.query_embedding(QUERY_IDS)
    queries = queries[None].expand(b, -1, -1).to(input_features.dtype)
    speech = torch.cat([queries, input_features], dim=1)
    hidden, out_lens = encoder(speech, input_feature_length + len(QUERY_IDS))
    logits = encoder.ctc_logits(hidden)
    posterior = torch.softmax(logits.float(), dim=-1).to(hidden.dtype)
    n = len(QUERY_IDS)
    return hidden[:, n:], posterior[:, n:], (out_lens - n).clamp(min=0)


Draws = Union[NoiseDraws, FrontendDraws]


def _project(model: TasuModel, feats: torch.Tensor, lens: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The projector over ``feats`` [B,T,D] and the embeds' lengths: the
    cross-attention projector over the LLM's embedding matrix (lengths
    unchanged); the q-former over the valid frames (``query_len`` a row);
    the others at ``lens // k``."""
    if model.flags.cross_attn:
        table = model.llm.embed_tokens.weight
        if model.llm.vocab is not None:
            table = gather_rows(table, model.llm.vocab)     # once a forward
        return model.projector(feats, table), lens
    if model.model_cfg.encoder_projector == "q-former":
        atts = torch.arange(feats.shape[1], device=feats.device)[None, :] < lens[:, None]
        out = model.projector(feats, atts)
        return out, torch.full_like(lens, out.shape[1])
    return model.projector(feats), lens // proj.downsample_rate(model.model_cfg)


def _voca_trans(model: TasuModel, encoder_out: torch.Tensor, lens: torch.Tensor,
                generate_mode: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """LegoSLM: LLM-vocabulary logits from the projector, PSD-pooled, mixing
    the LLM's embeddings by their softmax (or taking the top-1 token's)."""
    f = model.flags
    logits = model.projector(encoder_out)
    lens = lens // proj.downsample_rate(model.model_cfg)
    table = model.llm.embed_tokens.weight
    v_real = logits.shape[-1]
    if f.do_psd:
        probs = torch.softmax(logits.float(), dim=-1)
        blank = model.enc_cfg.blank_id if generate_mode else f.voca_trans_blank_id
        logits, lens = psd(logits, lens, probs, blank_id=blank,
                           blank_threshold=f.blank_threshold)
        v_real -= 1      # the last column (the CTC head's extra class) drops
        logits = logits[..., :v_real]
    ctc_outs = torch.softmax(logits.float(), dim=-1)
    vocab = model.llm.vocab
    if f.top1_emb:
        ids = ctc_outs.argmax(dim=-1)
        return (table[ids] if vocab is None else vocab_embed(table, ids, vocab)), lens
    if vocab is not None:
        return vocab_mix(ctc_outs.to(table.dtype), table, v_real, vocab), lens
    return ctc_outs.to(table.dtype) @ table[:v_real], lens


def compute_audio_embeds(
    model: TasuModel, batch: Dict[str, torch.Tensor], *, generate_mode: bool = False,
    generator: Optional[torch.Generator] = None, draws: Optional[Draws] = None,
    train: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(audio embeds [B,A,H], lens [B]) by the model's branch: the audio
    posterior (PSD-pooled when ``do_psd``) or, for text-only TASU, one
    simulated from the transcript ids, through the projector; voca_trans;
    or the encoder's output (the raw-feature baseline).

    Audio comes as ``input_features`` or, through the front end, as
    ``waveform``; the front end dithers and masks (as ``model.fbank_cfg``
    asks) when ``train`` and not ``generate_mode``.  The text-only noise
    (``gt_emb_noise``, off when ``generate_mode``) acts whatever ``train``
    is.  Either takes ``draws`` (a ``NoiseDraws`` for the text-only noise, a
    ``FrontendDraws`` for the front end) when given, else draws from
    ``generator``.  Under a mesh (``model.mesh``) the generator's draws are
    made at the global batch's shape and cut to this process's rows.
    """
    f = model.flags
    block = None if model.mesh is None else model.mesh.row_block
    want = NoiseDraws if not f.needs_encoder else FrontendDraws
    if draws is not None and not isinstance(draws, want):
        raise TypeError(f"this branch takes {want.__name__}, not {type(draws).__name__}")
    if f.needs_encoder:
        if "input_features" in batch:
            feats, flens = batch["input_features"], batch["input_feature_length"]
        else:
            feats, flens = frontend(
                batch["waveform"], batch["waveform_length"], cfg=model.fbank_cfg,
                cmvn=model.cmvn, train=train and not generate_mode, generator=generator,
                draws=draws, block=block,
            )
            feats = feats.to(model.llm.embed_tokens.weight.dtype)
        encoder_out, posterior, lens = encode_speech(model.encoder, feats, flens)
    blank = model.enc_cfg.blank_id
    if f.ctc_posterior and not f.voca_trans:
        if f.gt_emb:     # text-only TASU
            ids, lens = batch["gt_ids"], batch["gt_lens"]
            vocab = model.enc_cfg.vocab_size
            if f.gt_emb_noise and not generate_mode:
                if draws is None:
                    if generator is None:
                        raise ValueError(
                            "text-only noise (gt_emb_noise) needs a generator or draws")
                    draws = noise_draws(
                        ids.shape[0], ids.shape[1], generator, insert_prob=f.insert_prob,
                        smooth_low=f.smooth_low, smooth_high=f.smooth_high, block=block,
                    )
                post, lens = pseudo_posterior_noise(
                    ids, lens, draws, vocab_size=vocab, drop_prob=f.drop_prob,
                    insert_prob=f.insert_prob, blank_id=blank,
                )
            else:
                post, lens = pseudo_posterior(ids, lens, vocab)
            # the projector takes the compute dtype
            feats = post.to(model.llm.embed_tokens.weight.dtype)
        elif f.do_psd:
            feats, lens = psd(posterior, lens, posterior, blank_id=blank,
                              blank_threshold=f.blank_threshold)
        else:
            feats = posterior
        return _project(model, feats, lens)
    if f.ctc_posterior:
        return _voca_trans(model, encoder_out, lens, generate_mode)
    feats = encoder_out   # the raw-feature baseline
    if f.do_psd:
        feats, lens = psd(encoder_out, lens, posterior, blank_id=blank,
                          blank_threshold=f.blank_threshold)
    return _project(model, feats, lens)


def prepare_merged(
    model: TasuModel, batch: Dict[str, torch.Tensor], *, left_padding: bool = False,
    generate_mode: bool = False, generator: Optional[torch.Generator] = None,
    draws: Optional[Draws] = None, train: bool = False,
) -> Merged:
    """Audio embeds merged into the text embeddings at the speech token
    (span ``front_half``)."""
    with span("front_half"):
        audio_embeds, audio_lens = compute_audio_embeds(
            model, batch, generate_mode=generate_mode, generator=generator, draws=draws,
            train=train,
        )
        inputs_embeds = model.llm.embed(batch["input_ids"])
        return merge_audio_text(
            audio_embeds.to(inputs_embeds.dtype), audio_lens, inputs_embeds,
            batch["input_ids"], batch["attention_mask"], batch.get("labels"),
            speech_token_id=model.speech_token_id, ignore_id=IGNORE_ID,
            pad_token_id=model.pad_token_id, left_padding=left_padding,
        )


def forward(
    model: TasuModel, batch: Dict[str, torch.Tensor], *, train: bool = True,
    generator: Optional[torch.Generator] = None, draws: Optional[Draws] = None,
    lora_masks: Optional[List[Dict[str, torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training forward: ``(loss, {"acc", "ntokens"})``.

    Causal CE on the merged (right-padded) labels, HF shift semantics;
    accuracy is the argmax match over the labelled positions.  Rows with
    ``batch["batch_valid"]`` False contribute nothing.  The CE takes one of
    three forms, as in the JAX forward:

    1. gathered (only the labelled rows are unembedded) when the text is
       at most half the merged length; per row at most
       ``min(ceil(text_len / 8) * 8, T - 1)`` labels count;
    2. chunked, above 1.5 GB of fp32 logits;
    3. full fp32 logits otherwise.

    ``train`` is the JAX flag for dither and SpecAugment, which act only on
    the waveform front end: with ``input_features`` it changes nothing.
    The text-only noise stays on whatever ``train`` is, as in the JAX
    forward.  The branch's draws come from ``draws`` or ``generator``
    (:func:`compute_audio_embeds`).  LoRA dropout (``lora_dropout`` under
    PEFT) acts when ``train``: each layer's masks from ``lora_masks`` or,
    after the branch's draws, from ``generator``
    (:meth:`~ps_slm_tpu_torch.models.qwen2.Qwen2Model.forward`).

    Under a mesh the batch is this process's block of the global batch:
    the token count is summed over the batch axes, so the loss and the
    accuracy are this block's shares of the global means.

    Spans: ``front_half`` (:func:`prepare_merged`), ``llm``, ``loss``.
    """
    if "labels" not in batch:
        raise ValueError("the training forward needs batch['labels']")
    merged = prepare_merged(model, batch, left_padding=False, generator=generator,
                            draws=draws, train=train)
    with span("llm"):
        hidden, _ = model.llm(
            merged.embeds, merged.attention_mask, merged.position_ids,
            generator=generator if train else None, lora_masks=lora_masks if train else None,
        )
    with span("loss"):
        labels = merged.labels
        if "batch_valid" in batch:
            labels = torch.where(batch["batch_valid"][:, None], labels, IGNORE_ID)

        llm = model.llm
        w = llm.embed_tokens.weight if llm.lm_head is None else llm.lm_head.weight
        b, t = labels.shape
        text_len = batch["input_ids"].shape[1]
        reduce = None if model.mesh is None else model.mesh.batch_sum
        kw = dict(ignore_id=IGNORE_ID, reduce=reduce, vocab=llm.vocab)
        if text_len <= (t - 1) // 2:
            max_valid = min(-(-text_len // 8) * 8, t - 1)
            loss, acc, ntok = gathered_ce_loss(hidden, w, labels, max_valid=max_valid, **kw)
        elif b * t * llm.cfg.vocab_size * 4 > CHUNKED_CE_BYTES:
            loss, acc, ntok = chunked_ce_loss(hidden, w, labels, **kw)
        else:
            loss, acc, ntok = full_ce_loss(hidden, w, labels, **kw)
        return loss, {"acc": acc, "ntokens": ntok}


def trainable_mask(model: TasuModel, train_config) -> List[str]:
    """Apply the freeze flags: set ``requires_grad`` on every parameter and
    return the names of the trainable ones.

    freeze_encoder, freeze_projector and freeze_llm freeze their module
    whole, as the JAX ``trainable_mask`` does; frozen parameters get no
    gradient and no optimizer state.  Under PEFT (``use_peft``) the LLM
    trains only its adapters (``lora_a`` / ``lora_b``, ``prefix_k`` /
    ``prefix_v``, every layer's ``adaption_prompt`` / ``adaption_gate``,
    the masked layers' too, as in JAX), and ``embed_tokens`` with
    ``use_emb``, whatever ``freeze_llm`` says.
    """
    frozen = {
        "encoder": train_config.freeze_encoder,
        "projector": train_config.freeze_projector,
        "llm": train_config.freeze_llm,
    }

    def trains(name: str) -> bool:
        module = name.split(".")[0]
        if module == "llm" and train_config.use_peft:
            leaf = name.rpartition(".")[2]
            return leaf in ADAPTER_LEAVES or (
                train_config.use_emb and name.startswith("llm.embed_tokens."))
        return not frozen[module]

    names = []
    for name, p in model.named_parameters():
        train = trains(name)
        p.requires_grad_(train)
        if train:
            names.append(name)
    return names


# the decoders by ``model_type``: (config from HF config.json keys, model, HF loader)
LLMS = {
    "qwen2": (lambda c: Qwen2Config.tiny(**c), Qwen2Model, qwen2.load_hf_checkpoint),
    "deepseek_v3": (lambda c: deepseek_v3.DeepseekV3Config.tiny(**c),
                    deepseek_v3.DeepseekV3Model, deepseek_v3.load_hf_checkpoint),
}


def _llm_kind(model_type: str):
    if model_type not in LLMS:
        raise NotImplementedError(f"no decoder for model_type {model_type!r}; "
                                  f"the port has {sorted(LLMS)}")
    return LLMS[model_type]


def llm_config(overrides: Optional[dict]):
    """The decoder's config for ``llm_config_overrides`` (HF ``config.json``
    keys over the tiny test widths), by its ``model_type`` (qwen2 when
    absent)."""
    over = dict(overrides or {})
    return _llm_kind(over.pop("model_type", "qwen2"))[0](over)


def build_llm(cfg) -> nn.Module:
    """The decoder module of a config of :data:`LLMS`."""
    return _llm_kind(getattr(cfg, "model_type", "qwen2"))[1](cfg)


def load_llm(path: str):
    """(state dict, config) of an HF directory, by its ``model_type``."""
    import json
    import os

    with open(os.path.join(path, "config.json")) as f:
        model_type = json.load(f).get("model_type", "qwen2")
    return _llm_kind(model_type)[2](path)


@register_model("tasu")
def model_factory(
    train_config, model_config, *, device="cuda", dtype: torch.dtype = torch.float32,
    generator: Optional[torch.Generator] = None,
) -> TasuModel:
    """Build a TasuModel on ``device`` in ``dtype``.

    ``model_config.llm_path`` (an HF directory: ``config.json`` and
    safetensors; Qwen2, or DeepSeek-V3 by its ``model_type``, :data:`LLMS`)
    and ``encoder_path`` (a funasr SenseVoiceSmall directory: ``model.pt``
    and ``config.yaml``, ``encoder_config_overrides`` over the
    latter) load their module, each tensor cast once into the model's
    dtype; without a path the module is a random init, sized by the config
    overrides (the tiny test configs when absent, as in the JAX factory).
    ``ctc_linear`` (a torch checkpoint with ``ctc_head.weight`` / ``.bias``)
    loads into the simple_linear projector, as the JAX factory does.
    ``generator`` (default: seeded with ``train_config.seed`` on
    ``device``) draws every random weight; the same seed on another device
    type gives other weights, so to compare devices build once and move
    the model.  ``model.load_seconds`` holds each loaded module's wall
    seconds (file read and copy to the device).  ``quantization`` makes the
    LLM's projections weight-only int8 (``quant_bits`` 8) or group-wise int4
    (4, ``q4_group_size``) after loading.  ``use_peft`` then attaches
    ``peft_config``'s adapter (LoRA, prefix tuning or llama-adapter,
    :mod:`~ps_slm_tpu_torch.models.lora`) to the LLM, drawn from the same
    generator, and sets its LoRA dropout rate.
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    loaded, seconds = {}, {}
    if model_config.llm_path:
        loaded["llm"], llm_cfg = load_llm(model_config.llm_path)
        seconds["llm"] = time.perf_counter() - t0
    else:
        llm_cfg = llm_config(model_config.llm_config_overrides)
    enc_over = model_config.encoder_config_overrides or {}
    if model_config.encoder_path:
        t1 = time.perf_counter()
        loaded["encoder"], enc_cfg = load_funasr_encoder(model_config.encoder_path, **enc_over)
        seconds["encoder"] = time.perf_counter() - t1
    else:
        enc_cfg = SenseVoiceConfig.tiny(**enc_over)
    flags = TasuFlags.from_train_config(train_config, model_config)
    with torch.device("meta"):
        model = TasuModel(enc_cfg, llm_cfg, model_config, flags)
    model = model.to(dtype=dtype).to_empty(device=dev)
    model.remat = train_config.remat
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(train_config.seed)
    model.init_weights(generator)
    for name, state in loaded.items():
        t1 = time.perf_counter()
        getattr(model, name).load_state_dict(state)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds[name] += time.perf_counter() - t1
    if model_config.ctc_linear:
        # a pretrained CTC head into simple_linear's ``map``
        if model_config.encoder_projector != "simple_linear":
            raise ValueError("ctc_linear loads into the simple_linear projector, not "
                             f"{model_config.encoder_projector!r}")
        model.projector.load_state_dict(load_ctc_linear(model_config.ctc_linear))
    if train_config.quantization:
        # weight-only LLM from the weights in the model's dtype, as the JAX
        # factory quantizes its loaded or random parameters
        quantize_llm(model.llm, bits=train_config.quant_bits,
                     group_size=train_config.q4_group_size)
    if train_config.use_peft:
        # the adapters on the (loaded, quantized) LLM, from the same
        # generator, as the JAX factory attaches them last
        add_peft(model.llm, train_config.peft_config, generator)
        model.llm.lora_dropout = train_config.peft_config.lora_dropout
    model.load_seconds = seconds
    return model
