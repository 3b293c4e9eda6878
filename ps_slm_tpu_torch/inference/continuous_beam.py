"""Continuous (slot-pool) beam decoding.

Counterpart of ``ps_slm_tpu/inference/continuous_beam.py``: ``num_slots``
independent beam searches over one shared KV cache, slot i's
``num_beams`` hypotheses in cache rows ``[i * bm, (i + 1) * bm)``.  Each
pool step advances every slot one token with the HF beam rules of
:func:`~ps_slm_tpu_torch.inference.generate.beam_generate` (2 * bm
candidates, an EOS candidate banked only within the top bm, length-penalty
scores, every top-k's ties toward the lower index).

A slot stops early only when that cannot change its outcome: its bank is
full and the best alive score over the most favourable length penalty
(``max_new ** lp``, or 1 for a negative ``lp``) cannot beat the worst
banked one.  :func:`_finalize` then banks the alive beams at full length as
the static decoder's epilogue does, so each request's tokens equal the
static ``beam_generate``'s.  The run loop, refills and pipelined harvest
are :class:`~ps_slm_tpu_torch.inference.continuous._SlotPoolBase`'s; a
harvest that finds finished slots finalizes them in one batched call.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F

from ps_slm_tpu_torch.inference.continuous import (
    HostCopy, Merge, _SlotPoolBase, install_rows, prefill_rows,
)
from ps_slm_tpu_torch.inference.generate import NEG_INF, top_k, top_k_wide
from ps_slm_tpu_torch.ops import fp32_reciprocal


def _bank(fin_seqs, fin_scores, fin_valid, cand_seqs, cand_scores, newly):
    """Insert the newly finished candidates, keeping the best bm along the
    last score axis (``beam_generate``'s bank, over leading axes)."""
    bm = fin_scores.shape[-1]
    all_scores = torch.cat([fin_scores, torch.where(newly, cand_scores, NEG_INF)], dim=-1)
    all_seqs = torch.cat([fin_seqs, cand_seqs], dim=-2)
    all_valid = torch.cat([fin_valid, newly], dim=-1)
    best, idx = top_k(all_scores, bm)
    seqs = all_seqs.gather(-2, idx[..., None].expand(*idx.shape, all_seqs.shape[-1]))
    return seqs, best, all_valid.gather(-1, idx)


class ContinuousBeamDecoder(_SlotPoolBase):
    """Slot pool of independent beam searches over ``(key, B=1 batch)``
    requests; ``run`` yields ``(key, tokens)`` in completion order, each
    equal to the static ``beam_generate``'s.  The cache has capacity
    ``prefill_len + max_new_tokens``; a slot writes cell ``prefill_len + t -
    1`` with ``t <= max_new_tokens``, so no write leaves it."""

    _supports_stop_after = False   # banked hypotheses have no truncation equivalent
    _supports_stream = False       # hypotheses reorder until finalization

    def __init__(self, model, *, num_slots: int = 4, prefill_len: int,
                 max_new_tokens: int = 200, eos_token_id: int, num_beams: int = 4,
                 length_penalty: float = 1.0, sync_every: int = 8, kv_bits: int = 16,
                 merge: Optional[Merge] = None, device="cuda"):
        self._setup(model, num_slots=num_slots, prefill_len=prefill_len,
                    max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
                    sync_every=sync_every, kv_bits=kv_bits, merge=merge, device=device)
        self.bm, self.lp = num_beams, length_penalty
        self.capacity = prefill_len + max_new_tokens
        n, bm, dev, eos = num_slots, num_beams, self.dev, eos_token_id
        with torch.inference_mode():
            self.pool = SimpleNamespace(
                cache=self.llm.init_cache(n * bm, self.capacity, dtype=self.dtype,
                                          device=dev, kv_bits=kv_bits),
                pmask=torch.zeros(n * bm, self.capacity, dtype=torch.bool, device=dev),
                positions=torch.zeros(n, dtype=torch.long, device=dev),
                write_idx=torch.zeros(n, dtype=torch.long, device=dev),
                tokens=torch.full((n, bm), eos, dtype=torch.long, device=dev),
                scores=torch.full((n, bm), NEG_INF, device=dev),
                seqs=torch.full((n, bm, max_new_tokens), eos, dtype=torch.long, device=dev),
                t=torch.zeros(n, dtype=torch.long, device=dev),
                active=torch.zeros(n, dtype=torch.bool, device=dev),
                fin_seqs=torch.full((n, bm, max_new_tokens), eos, dtype=torch.long, device=dev),
                fin_scores=torch.full((n, bm), NEG_INF, device=dev),
                fin_valid=torch.zeros(n, bm, dtype=torch.bool, device=dev),
            )
            self._cells = torch.arange(self.capacity, device=dev)[None]
            self._beam = torch.arange(bm, device=dev)

    def _reset_slot(self, slot, key):
        self._keys[slot] = key

    def _insert_chunk(self, slots, embeds, mask, pos, *, k, extra, offset):
        """Prefill k requests in one B=k forward and install each in its
        slot block, the t = 0 EOS beams banked at length 1."""
        p, bm, eos = self.pool, self.bm, self.eos
        logits, cachek = prefill_rows(self.llm, embeds, mask, pos, self.kv_bits)
        top_val, top_tok = top_k_wide(torch.log_softmax(logits.float(), dim=-1), bm)
        s = embeds.shape[1]
        rows = (slots[:, None] * bm + self._beam).reshape(-1)
        install_rows(p.cache, cachek, rows, repeat=bm)
        p.pmask[rows] = F.pad(mask.bool(), (0, self.capacity - s)).repeat_interleave(bm, dim=0)
        p.positions[slots] = pos[:, -1] + 1
        p.write_idx[slots] = s
        p.tokens[slots] = top_tok
        seqs0 = torch.full((k, bm, self.max_new), eos, dtype=torch.long, device=self.dev)
        seqs0[:, :, 0] = top_tok
        p.seqs[slots] = seqs0
        beam_done = top_tok == eos
        fin = _bank(torch.full_like(seqs0, eos), torch.full((k, bm), NEG_INF, device=self.dev),
                    torch.zeros(k, bm, dtype=torch.bool, device=self.dev),
                    seqs0, top_val, beam_done)
        p.fin_seqs[slots], p.fin_scores[slots], p.fin_valid[slots] = fin
        p.scores[slots] = torch.where(beam_done, NEG_INF, top_val)
        p.t[slots] = 1
        p.active[slots] = True

    def _launch_chunk(self) -> HostCopy:
        """``sync_every`` beam steps over the whole pool; inactive slots'
        decode state stays frozen (their cache rows are never read again).
        The host copy holds the slots' active flags after the chunk."""
        p, bm, eos, max_new, lp = self.pool, self.bm, self.eos, self.max_new, self.lp
        n = p.active.shape[0]
        slots = torch.arange(n, device=self.dev)
        cols = torch.arange(max_new, device=self.dev)[None, None]
        expand = torch.arange(2 * bm, device=self.dev)[None]
        P = self.prefill_len
        # the most favourable length penalty a finish can get
        opt_div = float(max_new) ** lp if lp >= 0 else 1.0
        for _ in range(self.sync_every):
            kv_mask = p.pmask | ((self._cells >= P)
                                 & (self._cells < (p.write_idx + 1).repeat_interleave(bm)[:, None]))
            hidden, _ = self.llm(
                self.llm.embed(p.tokens.reshape(-1)[:, None]), attention_mask=kv_mask,
                position_ids=p.positions.repeat_interleave(bm)[:, None], cache=p.cache,
                cache_index=p.write_idx.repeat_interleave(bm))
            logits = self.llm.unembed(hidden)[:, 0]
            vocab = logits.shape[-1]
            logp = torch.log_softmax(logits.float(), dim=-1).reshape(n, bm, vocab)
            top, idx = top_k_wide((p.scores[:, :, None] + logp).reshape(n, bm * vocab), 2 * bm)
            src_beam, tok = idx // vocab, idx % vocab
            cand_seqs = p.seqs.gather(1, src_beam[..., None].expand(-1, -1, max_new))
            cand_seqs = torch.where(cols == p.t[:, None, None], tok[:, :, None], cand_seqs)
            is_eos = tok == eos
            newly = is_eos & (expand < bm) & p.active[:, None]
            lps = (p.t + 1).float() ** lp
            nfs, nfsc, nfv = _bank(p.fin_seqs, p.fin_scores, p.fin_valid, cand_seqs,
                                   top / lps[:, None], newly)
            keep, kidx = top_k(torch.where(is_eos, NEG_INF, top), bm)
            new_seqs = cand_seqs.gather(1, kidx[..., None].expand(-1, -1, max_new))
            beam_src = src_beam.gather(1, kidx)
            new_tok = tok.gather(1, kidx)
            # reorder the decode region of each slot's block by beam source
            flat_src = (slots[:, None] * bm + beam_src).reshape(-1)
            for layer in p.cache:
                for leaf in layer:
                    leaf[:, P:] = leaf[flat_src, P:]
            act = p.active
            p.tokens = torch.where(act[:, None], new_tok, p.tokens)
            p.seqs = torch.where(act[:, None, None], new_seqs, p.seqs)
            p.scores = torch.where(act[:, None], keep, p.scores)
            p.fin_seqs = torch.where(act[:, None, None], nfs, p.fin_seqs)
            p.fin_scores = torch.where(act[:, None], nfsc, p.fin_scores)
            p.fin_valid = torch.where(act[:, None], nfv, p.fin_valid)
            step = act.long()
            p.write_idx = p.write_idx + step
            p.positions = p.positions + step
            p.t = p.t + step
            opt = p.scores.max(dim=1).values * fp32_reciprocal(opt_div)
            cant_improve = p.fin_valid.all(dim=1) & (opt <= p.fin_scores.min(dim=1).values)
            p.active = act & ~cant_improve & (p.t < max_new)
        return HostCopy(p.active)

    def _finalize(self, slots: torch.Tensor) -> torch.Tensor:
        """The best hypothesis of each finished slot: the alive beams
        compete at full length against the bank, as ``beam_generate``'s
        epilogue.  [m, max_new_tokens]."""
        p = self.pool
        full = float(self.max_new) ** self.lp
        f_seqs, f_scores, f_valid = _bank(
            p.fin_seqs[slots], p.fin_scores[slots], p.fin_valid[slots], p.seqs[slots],
            p.scores[slots] * fp32_reciprocal(full), torch.ones_like(p.fin_valid[slots]))
        best = torch.where(f_valid, f_scores, NEG_INF).argmax(dim=1)
        return f_seqs[torch.arange(len(slots), device=self.dev), best]

    def _harvest_chunk(self, copy: HostCopy, snapshot, cap) -> list:
        (active,) = copy.get()
        done = [slot for slot, key, epoch in snapshot
                if self._keys[slot] == key and self._epoch[slot] == epoch and not active[slot]]
        if not done:
            return []
        with torch.inference_mode():
            seqs = self._finalize(torch.tensor(done, device=self.dev)).cpu().numpy()
        return [self._release(slot, seq[seq != self.eos].astype("int32"))
                for slot, seq in zip(done, seqs)]
