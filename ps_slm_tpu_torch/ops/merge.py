"""Merge audio-feature spans into the token embedding stream.

Counterpart of ``ps_slm_tpu/ops/merge.py``: the one ``<speech>`` token of
each row is replaced by that row's audio span; mask, labels (audio span ->
ignore) and position ids are rebuilt; right padding for training, left
padding for generation.  The output length is the static worst case
``S + A - 1``; validity is carried by the returned mask.  Destinations at or
past the output length are dropped, as the JAX scatter's ``mode="drop"``
does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Merged(NamedTuple):
    embeds: torch.Tensor                    # [B, OUT, E]
    attention_mask: torch.Tensor            # [B, OUT] bool
    labels: Optional[torch.Tensor]          # [B, OUT] int64 or None
    position_ids: torch.Tensor              # [B, OUT] int64
    input_ids: torch.Tensor                 # [B, OUT] (pad-filled; audio span = pad)


def merge_audio_text(
    audio_features: torch.Tensor,   # [B, A, E]
    audio_lens: torch.Tensor,       # [B]
    inputs_embeds: torch.Tensor,    # [B, S, E]
    input_ids: torch.Tensor,        # [B, S]
    attention_mask: torch.Tensor,   # [B, S] bool/int
    labels: Optional[torch.Tensor] = None,  # [B, S]
    *,
    speech_token_id: int,
    ignore_id: int = -100,
    pad_token_id: int = 0,
    left_padding: bool = False,
) -> Merged:
    b, a, e = audio_features.shape
    s = input_ids.shape[1]
    out_len = s + a - 1
    dev = inputs_embeds.device
    attention_mask = attention_mask.bool()
    audio_lens = audio_lens.to(device=dev, dtype=torch.int64)

    is_speech = input_ids == speech_token_id
    ph = torch.where(is_speech, audio_lens[:, None], 1)          # span widths
    start = torch.cumsum(ph, dim=1) - ph                          # span starts
    if left_padding:
        start = start + (out_len - ph.sum(dim=1))[:, None]        # rows end at out_len-1

    # text tokens
    text_ok = attention_mask & ~is_speech & (start < out_len)
    rows = torch.arange(b, device=dev)[:, None].expand(b, s)
    tb, tdst = rows[text_ok], start[text_ok]
    final_emb = torch.zeros(b, out_len, e, device=dev, dtype=inputs_embeds.dtype)
    final_emb[tb, tdst] = inputs_embeds[text_ok]
    final_mask = torch.zeros(b, out_len, device=dev, dtype=torch.bool)
    final_mask[tb, tdst] = True
    final_ids = torch.full(
        (b, out_len), pad_token_id, device=dev, dtype=input_ids.dtype
    )
    final_ids[tb, tdst] = input_ids[text_ok]
    final_labels = None
    if labels is not None:
        final_labels = torch.full((b, out_len), ignore_id, device=dev, dtype=torch.int64)
        final_labels[tb, tdst] = labels[text_ok].to(torch.int64)

    # audio frames at the speech token's span
    speech_start = torch.where(is_speech, start, 0).sum(dim=1)    # [B]
    frame = torch.arange(a, device=dev)[None, :]
    adst = speech_start[:, None] + frame
    audio_ok = (frame < audio_lens[:, None]) & (adst < out_len)
    arows = torch.arange(b, device=dev)[:, None].expand(b, a)
    final_emb[arows[audio_ok], adst[audio_ok]] = audio_features[audio_ok].to(final_emb.dtype)
    final_mask[arows[audio_ok], adst[audio_ok]] = True

    # position ids: cumsum - 1 over the mask, padding forced to 1
    csum = torch.cumsum(final_mask.to(torch.int64), dim=1) - 1
    position_ids = torch.where(final_mask, csum, 1)
    return Merged(final_emb, final_mask, final_labels, position_ids, final_ids)
