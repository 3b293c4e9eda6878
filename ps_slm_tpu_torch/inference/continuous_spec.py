"""Continuous slot-pool decoding with draft verification in every slot.

Counterpart of ``ps_slm_tpu/inference/continuous_spec.py``: the slot pool
of :mod:`~ps_slm_tpu_torch.inference.continuous` where each pool step is a
draft-verified window (:mod:`~ps_slm_tpu_torch.inference.speculative`)
instead of one token, so each forward advances every active slot by up to
``window`` tokens of its own draft.  The drafts, their lengths and the
cursors ride the pool state per slot; each request's tokens equal
``speculative_greedy_generate``'s, and so greedy decoding's.

The cache has capacity ``prefill_len + max_new_tokens + window``: a slot
writes cells ``[write_idx, write_idx + window)`` with ``write_idx <=
prefill_len + max_new_tokens - 1``, a finished slot the same cells again,
so no write leaves it.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ps_slm_tpu_torch.inference.continuous import (
    HostCopy, Merge, _SlotPoolBase, install_rows, prefill_rows,
)
from ps_slm_tpu_torch.inference.speculative import _accept, _verify_window


class ContinuousSpeculativeDecoder(_SlotPoolBase):
    """Slot pool whose steps verify a draft window per slot.

    ``run`` takes ``(key, (batch, draft_ids, draft_len))`` requests (drafts
    in the LLM vocabulary, e.g. the CTC transcript re-tokenized; only the
    first ``draft_len`` tokens, at most ``draft_max``, are read) and yields
    ``(key, tokens)`` in completion order."""

    def __init__(self, model, *, num_slots: int = 8, prefill_len: int,
                 max_new_tokens: int = 200, eos_token_id: int, window: int = 8,
                 draft_max: int = 256, sync_every: int = 2, kv_bits: int = 16,
                 merge: Optional[Merge] = None, device="cuda"):
        if window < 2:
            raise ValueError("speculative window must be >= 2")
        self._setup(model, num_slots=num_slots, prefill_len=prefill_len,
                    max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
                    sync_every=sync_every, kv_bits=kv_bits, merge=merge, device=device)
        self.window, self.d_max = window, draft_max
        self.capacity = prefill_len + max_new_tokens + window
        dev = self.dev

        def ints(fill=0):
            return torch.full((num_slots,), fill, dtype=torch.long, device=dev)
        with torch.inference_mode():
            self.pool = SimpleNamespace(
                cache=self.llm.init_cache(num_slots, self.capacity, dtype=self.dtype,
                                          device=dev, kv_bits=kv_bits),
                pmask=torch.zeros(num_slots, self.capacity, dtype=torch.bool, device=dev),
                positions=ints(), write_idx=ints(), last_tok=ints(eos_token_id),
                active=torch.zeros(num_slots, dtype=torch.bool, device=dev), gen=ints(),
                draft=torch.zeros(num_slots, max(draft_max, 1), dtype=torch.long, device=dev),
                dlens=ints(), cursor=ints(), tok0_buf=ints(eos_token_id),
                tok0_fresh=torch.zeros(num_slots, dtype=torch.bool, device=dev),
            )
            self._cells = torch.arange(self.capacity, device=dev)[None]

    def _payload_batch(self, payload):
        return payload[0]

    def _prepare_refill(self, slot_req):
        """The refill's draft rows and lengths (a draft may arrive padded
        wider than its length)."""
        rows = np.zeros((len(slot_req), max(self.d_max, 1)), np.int64)
        lens = np.zeros((len(slot_req),), np.int64)
        for i, (_, _, (_, draft, dlen)) in enumerate(slot_req):
            n = min(int(dlen), len(draft), self.d_max)
            rows[i, :n] = np.asarray(draft[:n], np.int64)
            lens[i] = n
        return rows, lens

    def _insert_chunk(self, slots, embeds, mask, pos, *, k, extra, offset):
        rows, lens = extra
        p = self.pool
        logits, cachek = prefill_rows(self.llm, embeds, mask, pos, self.kv_bits)
        tok0 = logits.argmax(dim=-1)
        drafts = torch.from_numpy(rows[offset:offset + k]).to(self.dev)
        dlens = torch.from_numpy(lens[offset:offset + k]).to(self.dev)
        s = embeds.shape[1]
        install_rows(p.cache, cachek, slots)
        p.pmask[slots] = F.pad(mask.bool(), (0, self.capacity - s))
        p.positions[slots] = pos[:, -1] + 1
        p.write_idx[slots] = s
        p.last_tok[slots] = tok0
        p.active[slots] = tok0 != self.eos
        p.gen[slots] = 1
        p.draft[slots] = drafts
        p.dlens[slots] = dlens
        # skip draft[0] when it is the prefill's token
        p.cursor[slots] = ((drafts[:, 0] == tok0) & (dlens > 0)).long()
        p.tok0_buf[slots] = tok0
        p.tok0_fresh[slots] = True

    def _launch_chunk(self) -> HostCopy:
        """``sync_every`` windows over the whole pool; the host copy holds
        (tokens [steps, slots, window] EOS past each take, takes [steps,
        slots], tok0, fresh)."""
        p, k = self.pool, self.window
        n = p.active.shape[0]
        toks = torch.empty(self.sync_every, n, k, dtype=torch.long, device=self.dev)
        accs = torch.empty(self.sync_every, n, dtype=torch.long, device=self.dev)
        o = torch.arange(k, device=self.dev)[None]
        for st in range(self.sync_every):
            preds, dtoks, dvalid = _verify_window(
                self.llm, p.cache, p.pmask, self._cells, self.prefill_len, p.draft, p.dlens,
                p.cursor, p.last_tok, p.write_idx, p.positions, p.active, k)
            emitted, acc, consumed = _accept(
                preds, dtoks, dvalid, p.draft, p.dlens, p.cursor, p.active,
                eos_token_id=self.eos, budget=(self.max_new - p.gen).clamp(min=0))
            hit_eos = ((emitted == self.eos) & (o < acc[:, None])).any(dim=1)
            last = emitted.gather(1, (acc - 1).clamp(min=0)[:, None])[:, 0]
            p.last_tok = torch.where(acc > 0, last, p.last_tok)
            p.cursor += torch.where(p.active, consumed, 0)
            p.gen += acc
            p.active &= ~hit_eos & (p.gen < self.max_new)
            p.positions += acc
            p.write_idx += acc
            toks[st] = torch.where(o < acc[:, None], emitted, self.eos)
            accs[st] = acc
        copy = HostCopy(toks, accs, p.tok0_buf, p.tok0_fresh)
        p.tok0_fresh.zero_()
        return copy

    def _harvest_chunk(self, copy: HostCopy, snapshot, cap) -> list:
        toks, accs, tok0, fresh = copy.get()
        done = []
        for slot, key, epoch in snapshot:
            if self._keys[slot] != key or self._epoch[slot] != epoch:
                continue        # finished and refilled: a stale column
            if fresh[slot]:
                self._toks[slot].append(int(tok0[slot]))
            finished = bool(self._toks[slot]) and self._toks[slot][-1] == self.eos
            if not finished:
                for st in range(toks.shape[0]):
                    for t in toks[st, slot, :accs[st, slot]]:
                        self._toks[slot].append(int(t))
                        if t == self.eos:
                            finished = True
                            break
                    if finished:
                        break
            self._emit_partial(slot, cap)
            n_real = len([t for t in self._toks[slot] if t != self.eos])
            if finished or n_real >= cap(key):
                done.append(self._finish(slot, cap))
        return done
