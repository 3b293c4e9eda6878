"""Decoding with a KV cache: greedy, sampling and beam search.

Counterpart of ``ps_slm_tpu/inference/generate.py``:

  * prefill: one forward over the merged, left-padded sequence writes the
    cache (capacity ``S + max_new_tokens``); its causal attention runs
    through the flash kernel over the prompt's own k/v;
  * greedy / sampling (:func:`greedy_generate`): a Python loop of one-token
    forwards over the cache (plain ``decode_attention``); rows are
    EOS-filled once finished and the loop stops when every row is done, as
    the JAX ``while_loop`` does;
  * beam search (:func:`beam_generate`, the default of :func:`generate`):
    the prefill once at batch B, the cache tiled to B * beams rows, then
    exactly ``max_new_tokens - 1`` steps with no early exit and no value
    read back to the host, as the JAX ``fori_loop``.

Every top-k breaks ties toward the lower index, as ``jax.lax.top_k`` does
(:func:`top_k`, :func:`top_k_wide`).  Sampling takes its Gumbel noise as an
input (JAX's ``categorical`` is ``argmax(logits + gumbel)``), drawn from a
``torch.Generator`` or from a hook that tests fill with JAX's draws.

``kv_bits=8`` keeps the cache int8 (``models/qwen2.py``).  Drafts
(``draft_ids``, ``draft_lens``) with ``num_beams=1`` switch :func:`generate`
to the draft-verified loop of :mod:`~ps_slm_tpu_torch.inference.speculative`,
whose tokens equal greedy decoding's; :func:`ctc_transcript_ids` gives the
CTC head's collapsed argmax, the free draft.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ps_slm_tpu_torch._build import resolve_device
from ps_slm_tpu_torch.models.qwen2 import Qwen2Model
from ps_slm_tpu_torch.models.tasu import TasuModel, encode_speech, prepare_merged
from ps_slm_tpu_torch.ops import fp32_reciprocal
from ps_slm_tpu_torch.ops.fbank import frontend

NEG_INF = -1e30
# a hook giving step t's Gumbel noise [B, V] fp32 (t = 0 for the first token)
GumbelHook = Callable[[int], torch.Tensor]


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis for narrow rows (the banks, the
    2 * beams candidates): a stable descending sort, so equal values keep
    the lower index first; one sort of a few elements a row."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_k_wide(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis for wide rows (the vocabulary,
    beams x vocabulary).  ``torch.topk`` promises no order among equal
    values, but its k-th value v is exact.  The k taken are every element
    above v (fewer than k) and the lowest-indexed ones equal to v: the k
    smallest of a key that puts the elements above v first (index - n),
    then those equal to v (index), then the rest (2n), each group in index
    order.  A stable sort of the k by value then keeps the lower index
    first among equal values.  Cost: two ``torch.topk`` and three
    elementwise passes over the row; no scan, no whole-row sort."""
    n = x.shape[-1]
    kth = torch.topk(x, k, dim=-1).values[..., -1:]
    pos = torch.arange(n, device=x.device, dtype=torch.int32).expand_as(x)
    key = torch.where(x > kth, pos - n, torch.where(x == kth, pos, 2 * n))
    sel = torch.topk(key, k, dim=-1, largest=False).values
    idx = torch.where(sel < 0, sel + n, sel).long()
    vals, order = top_k(x.gather(-1, idx), k)
    return vals, idx.gather(-1, order)


def _prefill(llm: Qwen2Model, embeds, attn_mask, position_ids, capacity: int,
             kv_bits: int = 16):
    b, s, _ = embeds.shape
    cache = llm.init_cache(b, capacity, dtype=llm.embed_tokens.weight.dtype,
                           device=embeds.device, kv_bits=kv_bits)
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


def _penalize(scores: torch.Tensor, seen: torch.Tensor, penalty: float) -> torch.Tensor:
    """The HF repetition rule on ``seen`` entries: positive scores divided
    by ``penalty``, the others multiplied by it."""
    penalized = torch.where(scores > 0, scores * fp32_reciprocal(penalty), scores * penalty)
    return torch.where(seen, penalized, scores)


def _mask_eos(scores: torch.Tensor, eos_token_id: int) -> torch.Tensor:
    scores = scores.clone()
    scores[..., eos_token_id] = NEG_INF
    return scores


def gumbel_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise in fp32, ``-log(-log(u))`` with u uniform on
    [tiny, 1), as ``jax.random.gumbel``'s default mode draws it."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u * (1.0 - tiny) + tiny))


def sample_from(
    logits: torch.Tensor, t: int, seen: Optional[torch.Tensor],
    gumbel: Optional[torch.Tensor], *, eos_token_id: int, do_sample: bool = False,
    temperature: float = 1.0, top_p: float = 1.0, min_length: int = 1,
    repetition_penalty: float = 1.0,
) -> torch.Tensor:
    """The JAX ``greedy_generate``'s ``sample_from``: in fp32, the repetition
    penalty on raw logits over the ``seen`` [B, V] tokens, ``min_length``
    masking EOS, then (sampling) temperature and top-p by sort, softmax,
    cumsum and cutoff.  Returns [B] int64: ``argmax(logits + gumbel)`` when
    sampling, ``argmax(logits)`` otherwise."""
    logits = logits.float()
    if repetition_penalty != 1.0 and seen is not None:
        logits = _penalize(logits, seen, repetition_penalty)
    if min_length > 1 and t < min_length - 1:
        logits = _mask_eos(logits, eos_token_id)
    if not do_sample:
        return logits.argmax(dim=-1)
    if temperature != 1.0:
        logits = logits * fp32_reciprocal(temperature)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.softmax(sorted_logits, dim=-1).cumsum(-1)
        cut_idx = (cum < top_p).sum(-1, keepdim=True)
        # an index past the row (every cumsum below top_p) reads a NaN in
        # JAX's take_along_axis, which masks nothing: -inf does the same
        cutoff = torch.where(
            cut_idx < logits.shape[-1],
            sorted_logits.gather(-1, cut_idx.clamp(max=logits.shape[-1] - 1)),
            -torch.inf,
        )
        logits = torch.where(logits < cutoff, NEG_INF, logits)
    return (logits + gumbel).argmax(dim=-1)


@torch.inference_mode()
def greedy_generate(
    llm: Qwen2Model,
    inputs_embeds: torch.Tensor,      # [B, S, H] merged, LEFT-padded
    attention_mask: torch.Tensor,     # [B, S]
    position_ids: torch.Tensor,       # [B, S]
    *,
    max_new_tokens: int = 200,
    eos_token_id: int = 0,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_p: float = 1.0,
    min_length: int = 1,
    repetition_penalty: float = 1.0,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[GumbelHook] = None,
    kv_bits: int = 16,
) -> torch.Tensor:
    """Greedy or sampled decode: [B, max_new_tokens] int64, EOS-filled after
    a row ends.  Sampling draws step t's Gumbel noise from ``gumbel(t)``
    when given, else from ``generator`` (default: seeded 0 on the inputs'
    device)."""
    b, s, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    logits, cache, full_mask = _prefill(
        llm, inputs_embeds, attention_mask, position_ids, s + max_new_tokens, kv_bits
    )
    next_pos = position_ids[:, -1] + 1   # left padding: the last position is valid
    vocab = logits.shape[-1]
    use_rep = repetition_penalty != 1.0
    seen = torch.zeros(b, vocab, dtype=torch.bool, device=dev) if use_rep else None
    if do_sample and gumbel is None:
        gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
        gumbel = lambda t: gumbel_noise((b, vocab), gen)          # noqa: E731

    def pick(logits, t):
        noise = gumbel(t).to(dev) if do_sample else None
        return sample_from(
            logits, t, seen, noise, eos_token_id=eos_token_id, do_sample=do_sample,
            temperature=temperature, top_p=top_p, min_length=min_length,
            repetition_penalty=repetition_penalty,
        )

    rows = torch.arange(b, device=dev)
    tokens = pick(logits, 0)
    out = torch.full((b, max_new_tokens), eos_token_id, dtype=torch.long, device=dev)
    out[:, 0] = tokens
    done = tokens == eos_token_id
    if use_rep:
        seen[rows, tokens] = True
    t = 1
    while t < max_new_tokens and not bool(done.all()):
        index = s + t - 1
        full_mask[:, index] = True
        logits, cache = _step(llm, cache, full_mask, tokens, next_pos + t - 1, index)
        tokens = torch.where(done, eos_token_id, pick(logits, t))
        out[:, t] = tokens
        done = done | (tokens == eos_token_id)
        if use_rep:
            seen[rows, tokens] = True
        t += 1
    return out


@torch.inference_mode()
def beam_generate(
    llm: Qwen2Model,
    inputs_embeds: torch.Tensor,      # [B, S, H] merged, LEFT-padded
    attention_mask: torch.Tensor,     # [B, S]
    position_ids: torch.Tensor,       # [B, S]
    *,
    max_new_tokens: int = 200,
    eos_token_id: int = 0,
    num_beams: int = 4,
    length_penalty: float = 1.0,
    min_length: int = 1,
    repetition_penalty: float = 1.0,
    kv_bits: int = 16,
) -> torch.Tensor:
    """Beam search with HF semantics, as the JAX ``beam_generate``: expand
    2 * beams candidates a step, bank an EOS candidate only when it ranks
    within the top ``num_beams``, keep the best ``num_beams`` unfinished
    ones alive, and pick the best length-penalised hypothesis at the end
    (generated length, EOS included).  The repetition penalty acts on each
    beam's log-softmax scores over its generated tokens.  Returns
    [B, max_new_tokens] int64."""
    b, s, _ = inputs_embeds.shape
    bm = num_beams
    dev = inputs_embeds.device
    rows = torch.arange(b, device=dev)

    # the prefill once at batch B, then the cache, mask and positions tiled
    # to B * bm rows (beam j of row i at i * bm + j)
    logits, cache, full_mask = _prefill(
        llm, inputs_embeds, attention_mask, position_ids, s + max_new_tokens, kv_bits
    )
    cache = [tuple(leaf.repeat_interleave(bm, dim=0) for leaf in layer) for layer in cache]
    full_mask = full_mask.repeat_interleave(bm, dim=0)
    next_pos = (position_ids[:, -1] + 1).repeat_interleave(bm, dim=0)
    vocab = logits.shape[-1]

    # t = 0: every beam of a row holds the same prefill, so the first
    # tokens are the row's top bm
    logp0 = torch.log_softmax(logits.float(), dim=-1)
    if min_length > 1:
        logp0 = _mask_eos(logp0, eos_token_id)
    scores, first = top_k_wide(logp0, bm)                           # [B, bm]
    seqs = torch.full((b, bm, max_new_tokens), eos_token_id, dtype=torch.long, device=dev)
    seqs[:, :, 0] = first
    beam_done = first == eos_token_id

    use_rep = repetition_penalty != 1.0
    seen = torch.zeros(b, bm, vocab, dtype=torch.bool, device=dev) if use_rep else None
    if use_rep:
        seen.scatter_(2, first[..., None], True)

    def bank(fin, cand_seqs, cand_scores, newly):
        """Insert the newly finished candidates, keeping the best bm."""
        fin_seqs, fin_scores, fin_valid = fin
        all_scores = torch.cat([fin_scores, torch.where(newly, cand_scores, NEG_INF)], dim=1)
        all_seqs = torch.cat([fin_seqs, cand_seqs], dim=1)
        all_valid = torch.cat([fin_valid, newly], dim=1)
        best, idx = top_k(all_scores, bm)
        return (all_seqs.gather(1, idx[..., None].expand(-1, -1, max_new_tokens)),
                best, all_valid.gather(1, idx))

    # the finished-hypothesis bank; EOS beams at t = 0 scored at length 1
    fin = (torch.full_like(seqs, eos_token_id),
           torch.full((b, bm), NEG_INF, device=dev),
           torch.zeros(b, bm, dtype=torch.bool, device=dev))
    fin = bank(fin, seqs, scores, beam_done)
    scores = torch.where(beam_done, NEG_INF, scores)
    tokens = first.reshape(b * bm)

    # the length penalty of step t, (t + 1) ** length_penalty, an fp32
    # power as in the JAX loop (its pow may round an ulp apart from torch's
    # when length_penalty is not an integer)
    lps = torch.arange(1, max_new_tokens + 1, dtype=torch.float32, device=dev).pow(
        torch.full((), length_penalty, dtype=torch.float32, device=dev))
    expand = torch.arange(2 * bm, device=dev)[None]
    for t in range(1, max_new_tokens):
        index = s + t - 1
        full_mask[:, index] = True
        logits, cache = _step(llm, cache, full_mask, tokens, next_pos + t - 1, index)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, bm, vocab)
        if use_rep:
            logp = _penalize(logp, seen, repetition_penalty)
        if min_length > 1 and t < min_length - 1:
            logp = _mask_eos(logp, eos_token_id)
        cand = (scores[:, :, None] + logp).reshape(b, bm * vocab)
        top, idx = top_k_wide(cand, 2 * bm)                        # [B, 2bm]
        src_beam, tok = idx // vocab, idx % vocab
        cand_seqs = seqs.gather(1, src_beam[..., None].expand(-1, -1, max_new_tokens))
        cand_seqs[:, :, t] = tok
        is_eos = tok == eos_token_id
        # HF banks an EOS candidate only when it ranks within the top bm
        newly = is_eos & (expand < bm)
        fin = bank(fin, cand_seqs, top / lps[t], newly)

        # keep the best bm unfinished candidates alive
        scores, keep = top_k(torch.where(is_eos, NEG_INF, top), bm)
        seqs = cand_seqs.gather(1, keep[..., None].expand(-1, -1, max_new_tokens))
        beam_src = src_beam.gather(1, keep)                          # [B, bm]
        new_tok = tok.gather(1, keep)
        tokens = new_tok.reshape(b * bm)
        if use_rep:
            seen = seen.gather(1, beam_src[..., None].expand(-1, -1, vocab))
            seen.scatter_(2, new_tok[..., None], True)

        # reorder the cache rows by beam source over the decode region
        # [s, s + max_new_tokens) only: the prefill cells are the same for
        # every beam of a row (tiled once, permuted within the row since)
        flat_src = (rows[:, None] * bm + beam_src).reshape(-1)
        for layer in cache:
            for leaf in layer:
                leaf[:, s:] = leaf[flat_src, s:]

    # unfinished beams compete with the banked ones at full length
    full = (float(max_new_tokens) ** length_penalty)
    fin_seqs, fin_scores, fin_valid = bank(
        fin, seqs, scores * fp32_reciprocal(full), torch.ones_like(beam_done))
    best = torch.where(fin_valid, fin_scores, NEG_INF).argmax(dim=1)
    return fin_seqs[rows, best]


@torch.inference_mode()
def ctc_transcript_ids(model: TasuModel, batch: Dict[str, torch.Tensor]) -> List[List[int]]:
    """The CTC head's argmax, runs collapsed and blanks (0) dropped, per row
    (the SenseVoice decode rule), from the same front end the merge uses:
    B lists of encoder-vocabulary ids, the free draft of speculative
    decoding.  ``batch`` lies on the model's device; the collapse runs on
    the host, as in the JAX package."""
    if "input_features" in batch:
        feats, flens = batch["input_features"], batch["input_feature_length"]
    else:
        feats, flens = frontend(
            batch["waveform"], batch["waveform_length"], cfg=model.fbank_cfg,
            cmvn=model.cmvn, train=False,
        )
        feats = feats.to(model.llm.embed_tokens.weight.dtype)
    _, posterior, lens = encode_speech(model.encoder, feats, flens)
    ids, lens = posterior.argmax(dim=-1).cpu().tolist(), lens.cpu().tolist()
    out = []
    for row, n in zip(ids, lens):
        toks, prev = [], -1
        for t in row[:n]:
            if t != prev and t != 0:
                toks.append(t)
            prev = t
        out.append(toks)
    return out


def generate(
    model: TasuModel, batch: Dict[str, torch.Tensor], *, eos_token_id: int,
    num_beams: int = 4, max_new_tokens: int = 200, device="cuda",
    length_penalty: float = 1.0, do_sample: bool = False, temperature: float = 1.0,
    top_p: float = 1.0, min_length: int = 1, repetition_penalty: float = 1.0,
    key: Optional[torch.Generator] = None, rng: Optional[torch.Generator] = None,
    gumbel: Optional[GumbelHook] = None, kv_bits: int = 16, draft_ids=None,
    draft_lens=None, spec_window: int = 8,
) -> torch.Tensor:
    """TASU generate: merge with LEFT padding (text-only models: the clean
    one-hot posterior), then beam search (``num_beams`` > 1, default 4 as
    in the JAX package) or greedy / sampled decoding (``num_beams=1``).

    ``batch`` is moved to ``device``, where the model must already be.
    ``key`` (alias ``rng``) is the ``torch.Generator`` sampling draws from;
    ``gumbel`` (port only) gives step t's noise instead.  ``kv_bits=8``
    keeps the KV cache int8.  ``draft_ids`` [B, D] / ``draft_lens`` [B]
    (LLM-vocabulary drafts) with ``num_beams=1`` run the draft-verified loop
    (windows of ``spec_window`` tokens), whose tokens equal greedy
    decoding's; it refuses the knobs that would change them.  With beams the
    drafts are ignored, as in the JAX package.
    """
    dev = resolve_device(device)
    speculative = draft_ids is not None and num_beams == 1
    if speculative and (do_sample or repetition_penalty != 1.0 or temperature != 1.0
                        or min_length > 1):
        raise ValueError(
            "draft-speculative decoding is bit-identical to plain greedy; "
            "do_sample/temperature/repetition_penalty/min_length are not "
            "supported with draft_ids"
        )
    model_dev = next(model.parameters()).device
    if model_dev != dev:
        raise ValueError(f"the model is on {model_dev}, generate was asked for {dev}")
    batch = {k: v.to(dev) for k, v in batch.items()}
    with torch.inference_mode():
        merged = prepare_merged(model, batch, left_padding=True, generate_mode=True)
    args = (model.llm, merged.embeds, merged.attention_mask, merged.position_ids)
    if speculative:
        from ps_slm_tpu_torch.inference.speculative import speculative_greedy_generate

        out, _ = speculative_greedy_generate(
            *args, torch.as_tensor(draft_ids).to(dev), torch.as_tensor(draft_lens).to(dev),
            max_new_tokens=max_new_tokens, eos_token_id=eos_token_id, window=spec_window,
            kv_bits=kv_bits,
        )
        return out
    common = dict(max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
                  min_length=min_length, repetition_penalty=repetition_penalty,
                  kv_bits=kv_bits)
    if num_beams > 1:
        return beam_generate(*args, num_beams=num_beams, length_penalty=length_penalty,
                             **common)
    return greedy_generate(
        *args, do_sample=do_sample, temperature=temperature, top_p=top_p,
        generator=key if key is not None else rng, gumbel=gumbel, **common,
    )
