"""SenseVoiceSmall on its own: the encoder's training loss and rich-label ASR.

Counterpart of ``ps_slm_tpu/models/sensevoice_asr.py``:

  * the rich query dictionaries (language, text normalisation, emotion);
  * :func:`rich_ce_loss`: label-smoothed CE over the 4 query frames;
  * :func:`encoder_train_loss`: CTC on frames 4 onward plus the rich CE on
    the 4 query frames, the objective an encoder training step minimises
    (the step itself is AdamW with warmup-cosine from
    :mod:`ps_slm_tpu_torch.training.train_state`, built by its caller);
  * :func:`inference`: query prepend -> encoder -> fp32 CTC log-softmax ->
    greedy decode (optionally banning the emotion-unk label) -> text, with
    token timestamps from Viterbi forced alignment at the 60 ms LFR frame
    rate.  The device half runs on the encoder's device, the Viterbi
    included; texts come from any tokenizer with ``decode(ids)`` (the
    SenseVoice BPE model: :mod:`ps_slm_tpu_torch.data.spm`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ps_slm_tpu_torch._build import resolve_device
from ps_slm_tpu_torch.models.sensevoice import SenseVoiceEncoder
from ps_slm_tpu_torch.ops.ctc import ctc_forced_align, ctc_greedy_decode, ctc_loss

LID_DICT = {"auto": 0, "zh": 3, "en": 4, "yue": 7, "ja": 11, "ko": 12, "nospeech": 13}
LID_INT_DICT = {24884: 3, 24885: 4, 24888: 7, 24892: 11, 24896: 12, 24992: 13}
TEXTNORM_DICT = {"withitn": 14, "woitn": 15}
TEXTNORM_INT_DICT = {25016: 14, 25017: 15}
EMO_DICT = {"unk": 25009, "happy": 25001, "sad": 25002, "angry": 25003, "neutral": 25004}
FRAME_MS = 60   # one LFR frame


def rich_ce_loss(
    logits: torch.Tensor,    # [B, 4, V] query-frame logits
    labels: torch.Tensor,    # [B, 4] rich labels
    smoothing: float = 0.0,
    ignore_id: int = -1,
) -> torch.Tensor:
    """Label-smoothed CE over the labelled query frames (fp32)."""
    valid = labels != ignore_id
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    if smoothing > 0.0:
        nll = (1 - smoothing) * nll + smoothing * -logp.mean(dim=-1)
    denom = valid.sum().clamp(min=1)
    return torch.where(valid, nll, 0.0).sum() / denom


def encoder_train_loss(
    encoder: SenseVoiceEncoder,
    speech: torch.Tensor,        # [B, T, input] with the 4 query frames prepended
    speech_lens: torch.Tensor,   # [B], the query frames counted
    text: torch.Tensor,          # [B, 4 + L]: 4 rich labels, then the CTC targets
    text_lens: torch.Tensor,     # [B], the rich labels counted
) -> Dict[str, torch.Tensor]:
    """``loss = CTC(frames 4+, text[:, 4:]) + richCE(frames :4, text[:, :4])``."""
    hidden, out_lens = encoder(speech, speech_lens)
    logits = encoder.ctc_logits(hidden)
    loss_ctc = ctc_loss(logits[:, 4:], out_lens - 4, text[:, 4:], text_lens - 4,
                        blank_id=encoder.cfg.blank_id)
    loss_rich = rich_ce_loss(logits[:, :4], text[:, :4])
    return {"loss": loss_ctc + loss_rich, "loss_ctc": loss_ctc, "loss_rich": loss_rich}


def prepend_queries(
    encoder: SenseVoiceEncoder, speech: torch.Tensor, lens: torch.Tensor,
    query_ids,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The query embeddings of ``query_ids`` (4 ids) before the frames."""
    q = encoder.query_embedding(list(query_ids))
    q = q[None].expand(speech.shape[0], -1, -1).to(speech.dtype)
    return torch.cat([q, speech], dim=1), lens + len(query_ids)


def _prepend_queries(
    encoder: SenseVoiceEncoder, speech: torch.Tensor, lens: torch.Tensor,
    language: str, textnorm: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inference order: ``[language, event 1, emotion 2, textnorm]``."""
    lid = LID_DICT.get(language, 0)
    tn = TEXTNORM_DICT.get(textnorm, 15)
    return prepend_queries(encoder, speech, lens, (lid, 1, 2, tn))


def _timestamps(frames, n_frames: int, pieces: List[str], blank: int) -> list:
    """[piece, start s, end s] for each non-blank run of the alignment."""
    ts, j, prev, run_start = [], 0, None, 0
    for idx, lab in enumerate(list(frames) + [None]):
        if lab != prev:
            if prev is not None and prev != blank:
                left = max((run_start * FRAME_MS - 30) / 1000, 0)
                right = min((idx * FRAME_MS - 30) / 1000, (n_frames * FRAME_MS - 30) / 1000)
                if j < len(pieces):
                    ts.append([pieces[j], left, right])
                    j += 1
            run_start = idx
            prev = lab
    return ts


@torch.inference_mode()
def inference(
    encoder: SenseVoiceEncoder,
    tokenizer,
    speech: torch.Tensor,          # [B, T, input] LFR features (no queries)
    speech_lens: torch.Tensor,     # [B]
    *,
    language: str = "auto",
    use_itn: bool = False,
    ban_emo_unk: bool = False,
    output_timestamp: bool = False,
    keys: Optional[List[str]] = None,
    device="cuda",
) -> List[Dict[str, Any]]:
    """Standalone rich-label ASR: ``[{"key", "text"[, "timestamp"]}]`` a row.

    ``speech`` is moved to ``device``, where the encoder must already be.
    ``timestamp`` lists ``[piece, start s, end s]`` for the tokens after the
    4 rich ones, from the alignment of the speech frames (the query frames
    dropped) in which a frame whose argmax is blank has its blank
    log-probability set to 0."""
    dev = resolve_device(device)
    enc_dev = next(encoder.parameters()).device
    if enc_dev != dev:
        raise ValueError(f"the encoder is on {enc_dev}, inference was asked for {dev}")
    blank = encoder.cfg.blank_id
    speech, speech_lens = speech.to(dev), speech_lens.to(dev)
    x, lens = _prepend_queries(encoder, speech, speech_lens, language,
                               "withitn" if use_itn else "woitn")
    hidden, out_lens = encoder(x, lens)
    log_probs = torch.log_softmax(encoder.ctc_logits(hidden).float(), dim=-1)
    if ban_emo_unk:
        log_probs[:, :, EMO_DICT["unk"]] = float("-inf")
    token_ids, token_lens = ctc_greedy_decode(log_probs, out_lens, blank=blank)

    b = speech.shape[0]
    if output_timestamp:
        speech_logp = log_probs[:, 4:]
        is_blank = speech_logp.argmax(dim=-1) == blank
        speech_logp = speech_logp.clone()
        speech_logp[..., blank] = torch.where(is_blank, 0.0, speech_logp[..., blank])
        # the targets skip the 4 rich tokens, left-compacted on the device
        n_tok = (token_lens.long() - 4).clamp(min=0)
        col = torch.arange(token_ids.shape[1], device=dev)[None, :]
        tgt = torch.where(col < n_tok[:, None],
                          token_ids.gather(1, (col + 4).clamp(max=token_ids.shape[1] - 1)), 0)
        align = ctc_forced_align(speech_logp, tgt, out_lens - 4, n_tok, blank=blank).cpu()
    token_ids, token_lens = token_ids.cpu().tolist(), token_lens.cpu().tolist()
    out_lens = out_lens.cpu().tolist()

    keys = keys or [f"utt{i}" for i in range(b)]
    results = []
    for i in range(b):
        ids = token_ids[i][: token_lens[i]]
        result: Dict[str, Any] = {"key": keys[i], "text": tokenizer.decode(ids)}
        if output_timestamp:
            n_frames = out_lens[i] - 4
            pieces = [tokenizer.decode([t]) for t in ids[4:]]
            result["timestamp"] = _timestamps(align[i, :n_frames].tolist(), n_frames, pieces,
                                              blank)
        results.append(result)
    return results
