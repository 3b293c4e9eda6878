"""Greedy decoding with a KV cache.

Counterpart of ``ps_slm_tpu/inference/generate.py`` for ``num_beams=1``:

  * prefill: one forward over the merged, left-padded sequence writes the
    cache (capacity ``S + max_new_tokens``); its causal attention runs
    through the flash kernel over the prompt's own k/v;
  * steps: a Python loop of one-token forwards, each attending over the
    cache with the plain ``decode_attention``; rows are EOS-filled once
    finished and the loop stops when every row is done.

Beam search, sampling and draft-verified (speculative) decoding raise for
now (ROADMAP.md queue 1, "Decode" and "Serving").
"""

from __future__ import annotations

from typing import Dict

import torch

from ps_slm_tpu_torch._build import resolve_device
from ps_slm_tpu_torch.models.qwen2 import Qwen2Model, init_cache
from ps_slm_tpu_torch.models.tasu import TasuModel, prepare_merged

# the JAX generate's other options, with the values plain greedy uses
_GREEDY_DEFAULTS = {
    "do_sample": False, "temperature": 1.0, "top_p": 1.0, "min_length": 1,
    "repetition_penalty": 1.0, "kv_bits": 16, "draft_ids": None,
    "draft_lens": None,
}
# options the JAX generate takes and plain greedy never reads, whatever
# their value: length_penalty reaches beam search only, key (alias rng) is
# drawn from only when sampling, spec_window is read only with draft_ids
_UNREAD_BY_GREEDY = frozenset({"length_penalty", "key", "rng", "spec_window"})


def _prefill(llm: Qwen2Model, embeds, attn_mask, position_ids, capacity: int):
    b, s, _ = embeds.shape
    cache = init_cache(
        llm.cfg, b, capacity, dtype=llm.embed_tokens.weight.dtype,
        device=embeds.device,
    )
    full_mask = torch.zeros(b, capacity, dtype=torch.bool, device=embeds.device)
    full_mask[:, :s] = attn_mask
    hidden, cache = llm(
        embeds, attention_mask=full_mask, position_ids=position_ids,
        cache=cache, cache_index=0,
    )
    logits = llm.unembed(hidden[:, -1:])[:, 0]               # [B, V] fp32
    return logits, cache, full_mask


def _step(llm: Qwen2Model, cache, full_mask, token_ids, positions, index: int):
    emb = llm.embed(token_ids[:, None])
    hidden, cache = llm(
        emb, attention_mask=full_mask, position_ids=positions[:, None],
        cache=cache, cache_index=index,
    )
    return llm.unembed(hidden)[:, 0], cache


@torch.inference_mode()
def greedy_generate(
    llm: Qwen2Model,
    inputs_embeds: torch.Tensor,      # [B, S, H] merged, LEFT-padded
    attention_mask: torch.Tensor,     # [B, S]
    position_ids: torch.Tensor,       # [B, S]
    *,
    max_new_tokens: int = 200,
    eos_token_id: int = 0,
) -> torch.Tensor:
    """Greedy decode: [B, max_new_tokens] int64, EOS-filled after a row ends."""
    b, s, _ = inputs_embeds.shape
    logits, cache, full_mask = _prefill(
        llm, inputs_embeds, attention_mask, position_ids, s + max_new_tokens
    )
    next_pos = position_ids[:, -1] + 1   # left padding: the last position is valid
    tokens = logits.argmax(dim=-1)
    out = torch.full(
        (b, max_new_tokens), eos_token_id, dtype=torch.long, device=tokens.device
    )
    out[:, 0] = tokens
    done = tokens == eos_token_id
    t = 1
    while t < max_new_tokens and not bool(done.all()):
        index = s + t - 1
        full_mask[:, index] = True
        logits, cache = _step(llm, cache, full_mask, tokens, next_pos + t - 1, index)
        tokens = torch.where(done, eos_token_id, logits.argmax(dim=-1))
        out[:, t] = tokens
        done = done | (tokens == eos_token_id)
        t += 1
    return out


def generate(
    model: TasuModel, batch: Dict[str, torch.Tensor], *, eos_token_id: int,
    num_beams: int = 4, max_new_tokens: int = 200, device="cuda", **kwargs,
) -> torch.Tensor:
    """TASU generate: merge with LEFT padding, then greedy decode.

    ``num_beams`` defaults to 4 as in the JAX package; only 1 is ported.
    ``batch`` is moved to ``device``, where the model must already be.
    The JAX generate's other keywords are taken as it takes them: those
    plain greedy never reads are ignored, the others must keep the value
    plain greedy uses.
    """
    dev = resolve_device(device)
    for key, value in kwargs.items():
        if key in _UNREAD_BY_GREEDY:
            continue
        if key not in _GREEDY_DEFAULTS:
            raise TypeError(f"generate() got an unexpected argument {key!r}")
        default = _GREEDY_DEFAULTS[key]
        if (value is not None) if default is None else (value != default):
            raise NotImplementedError(
                f"{key}={value!r} is not ported yet: sampling, int8 KV cache "
                "and draft-verified decoding wait for ROADMAP.md queue 1 "
                "('Serving', 'PEFT and quantization')"
            )
    if num_beams != 1:
        raise NotImplementedError(
            f"num_beams={num_beams}: beam search is not ported yet "
            "(ROADMAP.md queue 1, 'Decode'); pass num_beams=1"
        )
    model_dev = next(model.parameters()).device
    if model_dev != dev:
        raise ValueError(f"the model is on {model_dev}, generate was asked for {dev}")
    batch = {k: v.to(dev) for k, v in batch.items()}
    with torch.inference_mode():
        merged = prepare_merged(model, batch, left_padding=True)
    return greedy_generate(
        model.llm, merged.embeds, merged.attention_mask, merged.position_ids,
        max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
    )
