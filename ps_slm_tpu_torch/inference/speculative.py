"""Draft-verified (speculative) greedy decoding.

Counterpart of ``ps_slm_tpu/inference/speculative.py``.  A draft (the CTC
head's collapsed transcript, re-tokenized into the LLM vocabulary) is
verified ``window`` tokens at a time: one forward over ``[last token,
window - 1 draft tokens]`` at per-row cache offsets, the longest prefix of
draft tokens that equal the model's argmax accepted, then the model's own
next token.  The tokens equal greedy decoding's by construction; only the
number of forwards changes.  On a mismatch the draft cursor also skips the
rejected token (substitution recovery); when the bonus token equals the
next draft token, that one is consumed too.

The JAX ``lax.while_loop`` is a Python loop here: its test, "is any row
still decoding", reads one bool from the device each window, so a call
makes ``n_forwards`` host syncs (the prefill's test included).  Everything
else stays on the device.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ps_slm_tpu_torch.models.qwen2 import Qwen2Model


def _verify_window(llm: Qwen2Model, cache, prefill_mask, cells, prefill_len: int,
                   draft, dlens, cursor, last_tok, write_idx, pos, active, k: int):
    """One draft window over every row: (preds [B, k], dtoks [B, k-1],
    dvalid [B, k-1]).  ``active`` (None: every row) masks the draft of rows
    that no longer decode."""
    d_max = draft.shape[1]
    offs = cursor[:, None] + torch.arange(k - 1, device=cursor.device)
    dtoks = draft.gather(1, offs.clamp(0, d_max - 1))
    dvalid = offs < dlens[:, None]
    if active is not None:
        dvalid = dvalid & active[:, None]
    w = torch.cat([last_tok[:, None], dtoks], dim=1)
    kv_mask = prefill_mask | ((cells >= prefill_len) & (cells < (write_idx + k)[:, None]))
    positions = pos[:, None] + torch.arange(k, device=pos.device)
    hidden, _ = llm(llm.embed(w), attention_mask=kv_mask, position_ids=positions,
                    cache=cache, cache_index=write_idx)
    return llm.unembed(hidden).argmax(dim=-1), dtoks, dvalid


def _accept(preds, dtoks, dvalid, draft, dlens, cursor, live, *, eos_token_id: int, budget):
    """The JAX loop's acceptance arithmetic for one window: (emitted [B, k],
    acc [B] tokens taken, consumed [B] draft tokens used).  ``budget`` [B]
    caps acc (the tokens a row may still emit); rows not ``live`` take
    none."""
    k = preds.shape[1]
    d_max = draft.shape[1]
    o = torch.arange(k, device=preds.device)[None]
    match = (dtoks == preds[:, :-1]) & dvalid
    m = match.long().cumprod(dim=1).sum(dim=1)
    bonus = preds.gather(1, m[:, None])[:, 0]
    emitted = torch.where(o < m[:, None], F.pad(dtoks, (0, 1)),
                          torch.where(o == m[:, None], bonus[:, None], eos_token_id))
    acc = m + 1
    is_eos = (emitted == eos_token_id) & (o < acc[:, None])
    first_eos = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1) + 1, acc)
    acc = torch.minimum(torch.minimum(first_eos, acc), budget)
    acc = torch.where(live, acc, 0)
    mismatched = (m < k - 1) & dvalid.gather(1, m.clamp(max=max(k - 2, 0))[:, None])[:, 0]
    bonus_off = cursor + m
    bonus_draft = draft.gather(1, bonus_off.clamp(0, d_max - 1)[:, None])[:, 0]
    bonus_hit = ~mismatched & (bonus_off < dlens) & (bonus_draft == bonus) & (acc == m + 1)
    consumed = m + mismatched.long() + bonus_hit.long()
    return emitted, acc, consumed


def _pad_drafts(draft_ids: torch.Tensor) -> torch.Tensor:
    """Drafts as int64, at least one column wide (a zero-width draft gathers
    a zero that ``draft_lens`` 0 masks)."""
    draft_ids = draft_ids.long()
    if draft_ids.shape[1] == 0:
        draft_ids = F.pad(draft_ids, (0, 1))
    return draft_ids


@torch.inference_mode()
def speculative_greedy_generate(
    llm: Qwen2Model,
    inputs_embeds: torch.Tensor,      # [B, S, H] merged, LEFT-padded
    attention_mask: torch.Tensor,     # [B, S]
    position_ids: torch.Tensor,       # [B, S]
    draft_ids: torch.Tensor,          # [B, D] LLM-vocabulary drafts
    draft_lens: torch.Tensor,         # [B]
    *,
    max_new_tokens: int = 200,
    eos_token_id: int = 0,
    window: int = 8,
    kv_bits: int = 16,
) -> Tuple[torch.Tensor, int]:
    """Greedy decode with draft verification: (tokens [B, max_new_tokens]
    int64, EOS-filled; n_forwards, the LLM forwards run, the prefill
    included)."""
    if window < 2:
        raise ValueError("speculative window must be >= 2")
    b, s, _ = inputs_embeds.shape
    k = window
    dev = inputs_embeds.device
    capacity = s + max_new_tokens + k      # room for a partly used window
    cache = llm.init_cache(b, capacity, dtype=llm.embed_tokens.weight.dtype, device=dev,
                           kv_bits=kv_bits)
    prefill_mask = torch.zeros(b, capacity, dtype=torch.bool, device=dev)
    prefill_mask[:, :s] = attention_mask
    hidden, _ = llm(inputs_embeds, attention_mask=prefill_mask, position_ids=position_ids,
                    cache=cache, cache_index=0)
    tok0 = llm.unembed(hidden[:, -1:])[:, 0].argmax(dim=-1)

    draft = _pad_drafts(draft_ids)
    dlens = draft_lens.long()
    out = torch.full((b, max_new_tokens), eos_token_id, dtype=torch.long, device=dev)
    out[:, 0] = tok0
    cells = torch.arange(capacity, device=dev)[None]
    cols = torch.arange(max_new_tokens, device=dev)[None]
    # the draft covers the whole continuation: skip its first token when the
    # prefill already emitted it
    cursor = ((draft[:, 0] == tok0) & (dlens > 0)).long()
    n_out = torch.ones(b, dtype=torch.long, device=dev)
    write_idx = torch.full((b,), s, dtype=torch.long, device=dev)
    pos = position_ids[:, -1] + 1
    last_tok, done, n_fwd = tok0, tok0 == eos_token_id, 1

    while bool((~done).any()):            # one host sync a window
        preds, dtoks, dvalid = _verify_window(
            llm, cache, prefill_mask, cells, s, draft, dlens, cursor, last_tok,
            write_idx, pos, None, k)
        emitted, acc, consumed = _accept(
            preds, dtoks, dvalid, draft, dlens, cursor, ~done, eos_token_id=eos_token_id,
            budget=max_new_tokens - n_out)
        rel = cols - n_out[:, None]
        take = (rel >= 0) & (rel < acc[:, None])
        out = torch.where(take, emitted.gather(1, rel.clamp(0, k - 1)), out)
        o = torch.arange(k, device=dev)[None]
        hit_eos = ((emitted == eos_token_id) & (o < acc[:, None])).any(dim=1)
        n_out = n_out + acc
        done = done | hit_eos | (n_out >= max_new_tokens)
        last = emitted.gather(1, (acc - 1).clamp(min=0)[:, None])[:, 0]
        last_tok = torch.where(acc > 0, last, last_tok)
        write_idx, pos = write_idx + acc, pos + acc
        cursor = cursor + consumed
        n_fwd += 1
    return out, n_fwd
