"""Continuous (slot-pool) greedy decoding.

Counterpart of ``ps_slm_tpu/inference/continuous.py``.  A pool of
``num_slots`` sequences decodes over one shared KV cache; a slot that ends
(EOS, its cap, ``max_new_tokens``) is refilled with the next request's
prefill at once, so the decode products stay at the pool's batch.

* **Refills** run the front half (encoder, posterior, PSD, projector,
  merge) over the requests padded to shared shapes by the collator's rule
  and stacked, in as few calls as :data:`FRONT_HALF_BYTES` allows
  (:func:`front_half_calls`), left-pad each merged prefill to the pool's
  bucket ``prefill_len`` and prefill k requests in one B=k forward
  (:func:`_insert_slots`; only the last position is unembedded).  The
  first token stays on the device, in the pool state's ``tok0`` channel.
* **A chunk** is ``sync_every`` one-token steps over the whole pool
  (:func:`_pool_steps`), each slot at its own cache offset and position;
  finished slots are carried masked.  Every shape is fixed and every pool
  tensor is written in place, so on a CUDA device the pool records one
  chunk as a CUDA graph at construction, while it is idle, and each launch
  replays it: one graph launch in place of the chunk's thousands of kernel
  launches.  On the CPU it runs the same function eagerly.
* **The pipelined harvest**: chunk k + 1 is launched before chunk k's
  tokens are read.  Right after a chunk is launched its tokens (and
  ``tok0`` / ``fresh``) are copied without blocking into pinned host
  memory, and an event is recorded; the harvest waits on that event only,
  not on the chunk queued after it.  The pool state is updated in place
  (the JAX package donates only the cache), so whatever the harvest reads
  across the next launch is such a copy.  A finished slot decodes at most
  one chunk too many before its refill lands; the epoch check drops those
  columns.
* **The provably-done skip**: the host bounds each slot's progress, and
  when every busy slot has reached its cap and a harvest is in flight to
  free them, the next chunk is not launched.

Pool and refill state stay on the device; only harvested tokens (and the
beam pool's finished flags) come to the host.  ``merge`` (default: the
model's ``prepare_merged`` with left padding) maps a request's batch to
its merged prefill; the tests give one that skips the front half.
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ps_slm_tpu_torch._build import resolve_device
from ps_slm_tpu_torch.inference.static_serve import LEFT_PADDED, RIGHT_PADDED, pad_rows
from ps_slm_tpu_torch.utils.profiler import count, span

Merge = Callable[[Dict[str, torch.Tensor]], SimpleNamespace]


def default_merge(model) -> Merge:
    """The model's front half in generate mode, left-padded, as
    :func:`~ps_slm_tpu_torch.inference.generate.generate` merges."""
    from ps_slm_tpu_torch.models.tasu import prepare_merged

    def merge(batch):
        with torch.inference_mode():
            return prepare_merged(model, batch, left_padding=True, generate_mode=True)
    return merge


def _left_pad_merged(merged, prefill_len: int):
    """Left-pad a merged B=1 prefill to the pool's prefill bucket
    (positions padded with 0); counts its positions (``pool.prefill_valid``:
    the merged row's length as the host knows it, a stacked call's for
    each of its rows) and the padding."""
    s = merged.embeds.shape[1]
    if s > prefill_len:
        raise ValueError(
            f"merged length {s} exceeds pool prefill bucket {prefill_len}; "
            "raise prefill_len or the dataset buckets"
        )
    pad = prefill_len - s
    count("pool.prefill_valid", s)
    count("pool.prefill_padded", pad)
    if pad == 0:
        return merged.embeds, merged.attention_mask, merged.position_ids
    return (F.pad(merged.embeds, (0, 0, pad, 0)), F.pad(merged.attention_mask, (pad, 0)),
            F.pad(merged.position_ids, (pad, 0)))


# A front-half call's CTC posterior (rows x padded frames x the encoder's
# vocabulary x 4 bytes) is held to this: the front half's other buffers
# scale with it, and 1 GiB is 20 rows of 30.72 s at SenseVoiceSmall's
# 25 055, so a steady refill of a few rows is one call while the first
# turnover of a 32- or 64-slot pool splits into a few.
FRONT_HALF_BYTES = 1 << 30


def _frames(batch: Dict) -> int:
    """A padded row's encoder frames as the budget counts them: the rows of
    its features, its waveform's 60 ms LFR frames (960 samples at 16 kHz),
    or its transcript ids (text-only)."""
    for key, per in (("input_features", 1), ("waveform", 960), ("gt_ids", 1)):
        if key in batch:
            return max(batch[key].shape[1] // per, 1)
    return 1


def _paddable(rows: List[Dict]) -> bool:
    """Whether :func:`pad_rows` can stack these B=1 batches: one key set,
    every value a tensor of one row, and the keys it does not pad of one
    shape in every row."""
    keys = rows[0].keys()
    if not {"input_ids", "attention_mask"} <= keys or any(r.keys() != keys for r in rows):
        return False
    if not all(hasattr(v, "shape") and len(v.shape) and v.shape[0] == 1
               for r in rows for v in r.values()):
        return False
    return all(len({tuple(r[k].shape) for r in rows}) == 1
               for k in keys if k not in LEFT_PADDED | RIGHT_PADDED)


def _pow2_chunks(n: int) -> Iterator[Tuple[int, int]]:
    """(start, size) of the power-of-two chunks, largest first, covering n."""
    i = 0
    while i < n:
        k = 1 << ((n - i).bit_length() - 1)
        yield i, k
        i += k


def front_half_calls(rows: List[Dict], width: int) -> List[List[int]]:
    """A refill's front-half calls, each a list of indices into ``rows``.
    Rows :func:`pad_rows` can stack go in order of padded frames, as many
    a call as keep ``rows x frames x width x 4`` bytes (the call padded to
    its longest row) within :data:`FRONT_HALF_BYTES`.  Other payloads (a
    key without a shape, or a key outside the padding rule whose shapes
    differ) are grouped by exact shapes, in power-of-two chunks, or run
    alone."""
    if _paddable(rows):
        calls: List[List[int]] = [[]]
        for i in sorted(range(len(rows)), key=lambda i: _frames(rows[i])):
            if calls[-1] and (len(calls[-1]) + 1) * _frames(rows[i]) * width * 4 > FRONT_HALF_BYTES:
                calls.append([])
            calls[-1].append(i)
        return calls
    groups: Dict[tuple, list] = {}
    for i, batch in enumerate(rows):
        if all(hasattr(v, "shape") for v in batch.values()):
            sig = tuple(sorted((k, tuple(v.shape)) for k, v in batch.items()))
        else:
            sig = ("singleton", i)       # payloads without shapes: no stacking
        groups.setdefault(sig, []).append(i)
    return [idxs[i:i + k] for idxs in groups.values() for i, k in _pow2_chunks(len(idxs))]


def _merged_rows(merge: Merge, batches: List[Dict], pad_id: int) -> list:
    """The front half of B=1 batches in one call over :func:`pad_rows`'
    stack (every front-half op is row-independent over padded rows), split
    back into rows; a row of a stack is left-padded to the call's merged
    length.  Counts the call and its rows."""
    count("pool.front_half_calls")
    count("pool.front_half_rows", len(batches))
    if len(batches) == 1:
        return [merge(batches[0])]
    m = merge(pad_rows(batches, pad_id))
    return [SimpleNamespace(embeds=m.embeds[i:i + 1], attention_mask=m.attention_mask[i:i + 1],
                            position_ids=m.position_ids[i:i + 1])
            for i in range(len(batches))]


def _padded_prefills(merge: Merge, rows: List[Dict], prefill_len: int, *, pad_id: int,
                     width: int) -> list:
    """Run the front half over B=1 batch dicts in :func:`front_half_calls`'
    calls (``width``: the posterior's) and left-pad each merged prefill to
    the bucket: ``(embeds, mask, pos)`` per row, in ``rows``' order."""
    padded = [None] * len(rows)
    for call in front_half_calls(rows, width):
        for j, m in zip(call, _merged_rows(merge, [rows[j] for j in call], pad_id)):
            padded[j] = _left_pad_merged(m, prefill_len)
    return padded


def prefill_rows(llm, embeds, attn_mask, position_ids, kv_bits: int):
    """One B=k prefill forward over a left-padded bucket: (last-position
    logits [k, V] fp32, its cache of capacity S)."""
    k, s, _ = embeds.shape
    cache = llm.init_cache(k, s, dtype=llm.embed_tokens.weight.dtype, device=embeds.device,
                           kv_bits=kv_bits)
    hidden, _ = llm(embeds.to(llm.embed_tokens.weight.dtype), attention_mask=attn_mask,
                    position_ids=position_ids, cache=cache, cache_index=0)
    return llm.unembed(hidden[:, -1:])[:, 0], cache


def install_rows(pool_cache, cachek, rows: torch.Tensor, repeat: int = 1) -> None:
    """Copy a prefill cache's rows (capacity S) into pool cache rows
    ``rows`` (each prefill row ``repeat`` times), zeroing the cells past S,
    as the JAX insert copies a whole zero-initialised row.  Every leaf of
    every LLM's cache has the batch on axis 0 and the capacity on axis 1."""
    s = cachek[0][0].shape[1]
    for layer, layer_k in zip(pool_cache, cachek):
        for leaf, leaf_k in zip(layer, layer_k):
            leaf[rows, :s] = leaf_k.repeat_interleave(repeat, dim=0)
            leaf[rows, s:] = 0


class HostCopy:
    """Device tensors copied to the host without waiting: pinned buffers
    filled by ``non_blocking`` copies queued behind the work that produced
    them, and an event recorded after; :meth:`get` waits on that event
    only.  CPU tensors are cloned."""

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        if tensors[0].is_cuda:
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = [t.clone() for t in tensors]

    def get(self) -> List[np.ndarray]:
        if self.event is not None:
            with span("pool.harvest_wait"):
                self.event.synchronize()
        return [h.numpy() for h in self.host]


class _SlotPoolBase:
    """The run loop of the greedy, beam and speculative pools, as the JAX
    ``_SlotPoolBase``: admission (a ``None`` from a live source hands control
    back to the step loop), grouped refills, the pipelined harvest and the
    provably-done chunk skip (``inflight is not None`` keeps a slot refilled
    after the in-flight chunk's launch from livelocking the skip).

    Subclass hooks: ``_insert_chunk`` (install k prefilled requests),
    ``_reset_slot``, ``_launch_chunk`` (launch one chunk, return a
    :class:`HostCopy`), ``_harvest_chunk`` (read it, return the finished
    ``(key, tokens)`` in order), and ``_payload_batch`` / ``_prepare_refill``
    for payloads that carry more than the batch dict (the speculative
    drafts).

    Spans (``utils/profiler.py``): ``pool.admit`` (each pull from the
    source), ``pool.refill`` (the front half and ``pool.prefill``, the B=k
    prefill and install), ``pool.launch``, ``pool.harvest`` (with
    ``pool.harvest_wait``, the wait on the chunk's copy); counters
    ``pool.requests``, ``pool.chunks``, ``pool.slot_steps``,
    ``pool.tokens``, ``pool.slot_s``, ``pool.front_half_calls`` and
    ``pool.front_half_rows``.
    """

    _supports_stop_after = True
    _supports_stream = True      # beam hypotheses reorder, so the beam pool opts out

    def _setup(self, model, *, num_slots, prefill_len, max_new_tokens, eos_token_id,
               sync_every, kv_bits, merge, device):
        self.dev = resolve_device(device)
        model_dev = model.llm.embed_tokens.weight.device
        if model_dev != self.dev:
            raise ValueError(f"the model is on {model_dev}, the pool was asked for {self.dev}")
        self.model, self.llm = model, model.llm
        self.merge = merge if merge is not None else default_merge(model)
        self._pad_id = int(getattr(model, "pad_token_id", 0) or 0)
        # the front half's CTC posterior width, which bounds its calls' rows
        self._width = getattr(getattr(model, "enc_cfg", None), "vocab_size", 0)
        self.num_slots, self.prefill_len = num_slots, prefill_len
        self.max_new, self.eos = max_new_tokens, eos_token_id
        self.sync_every, self.kv_bits = sync_every, kv_bits
        self.dtype = self.llm.embed_tokens.weight.dtype
        self._keys: list = [None] * num_slots
        self._toks: list = [[] for _ in range(num_slots)]
        self._epoch: list = [0] * num_slots
        # a host bound on each slot's device progress (insert sets 1, each
        # launched chunk adds sync_every): the provably-done skip reads it
        self._t_host: list = [0] * num_slots
        self._installed: list = [0.0] * num_slots     # perf_counter at each install

    def _payload_batch(self, payload):
        return payload

    def _prepare_refill(self, slot_req):
        return None

    def _reset_slot(self, slot, key):
        self._keys[slot] = key
        self._toks[slot] = []

    def _refill_many(self, slot_req) -> None:
        padded = _padded_prefills(
            self.merge, [self._payload_batch(p) for _, _, p in slot_req], self.prefill_len,
            pad_id=self._pad_id, width=self._width)
        extra = self._prepare_refill(slot_req)
        for i, k in _pow2_chunks(len(slot_req)):
            chunk, ms = slot_req[i:i + k], padded[i:i + k]
            with span("pool.prefill"), torch.inference_mode():
                self._insert_chunk(
                    torch.tensor([s for s, _, _ in chunk], device=self.dev),
                    torch.cat([e for e, _, _ in ms]), torch.cat([m for _, m, _ in ms]),
                    torch.cat([p for _, _, p in ms]), k=k, extra=extra, offset=i)
            now = time.perf_counter()
            for slot, key, _ in chunk:
                self._reset_slot(slot, key)
                self._epoch[slot] += 1
                self._t_host[slot] = 1
                self._emitted_n[slot] = 0
                self._installed[slot] = now
            count("pool.requests", k)

    def _release(self, slot, tokens: np.ndarray):
        """Free a finished slot; ``(key, tokens)`` for the caller."""
        key = self._keys[slot]
        self._keys[slot] = None
        self._free.append(slot)
        count("pool.tokens", len(tokens))
        count("pool.slot_s", time.perf_counter() - self._installed[slot])
        return key, tokens

    def _finish(self, slot, cap):
        """Free a token-accumulating slot (greedy, speculative)."""
        toks = [t for t in self._toks[slot] if t != self.eos][: cap(self._keys[slot])]
        self._toks[slot] = []
        return self._release(slot, np.asarray(toks, np.int32))

    def _emit_partial(self, slot, cap):
        """Pass the clean (EOS-free, capped) prefix to ``on_partial`` when a
        harvest grew it."""
        if self._on_partial is None:
            return
        key = self._keys[slot]
        clean = [t for t in self._toks[slot] if t != self.eos][: cap(key)]
        if len(clean) > self._emitted_n[slot]:
            self._emitted_n[slot] = len(clean)
            self._on_partial(key, np.asarray(clean, np.int32))

    def run(self, batches: Iterator[Tuple[str, Dict]], stop_after: Optional[Dict[str, int]] = None,
            on_partial=None) -> Iterator[Tuple[str, np.ndarray]]:
        """Decode ``(key, payload)`` requests; yields ``(key, tokens)`` int32,
        EOS left out, in completion order.  ``stop_after`` caps a request's
        tokens (the slot frees at the next harvest); ``on_partial(key,
        prefix)`` streams each grown clean prefix (not the beam pool)."""
        if stop_after and not self._supports_stop_after:
            raise ValueError(f"{type(self).__name__} does not support stop_after")
        if on_partial is not None and not self._supports_stream:
            raise ValueError(
                f"{type(self).__name__} does not support on_partial "
                "(beam hypotheses have no stable prefix until finalization)")
        self._on_partial = on_partial
        self._emitted_n = [0] * self.num_slots
        batches = iter(batches)
        self._free = list(range(self.num_slots))
        exhausted = False
        inflight = None        # (HostCopy, busy snapshot)

        def cap(key):
            if stop_after and key in stop_after:
                return max(min(stop_after[key], self.max_new), 1)
            return self.max_new

        while True:
            pending, got_none = [], False
            while self._free and not exhausted:
                try:
                    with span("pool.admit"):
                        item = next(batches)
                except StopIteration:
                    exhausted = True
                    break
                if item is None:        # a live source with nothing ready
                    got_none = True
                    break
                key, payload = item
                pending.append((self._free.pop(), key, payload))
            if pending:
                with span("pool.refill"):
                    self._refill_many(pending)

            busy = [i for i in range(self.num_slots) if self._keys[i] is not None]
            if not busy and inflight is None:
                if exhausted:
                    return
                if got_none:
                    time.sleep(0.001)
                continue

            all_done = all(self._t_host[i] >= cap(self._keys[i]) for i in busy)
            nxt = None
            if busy and not (all_done and inflight is not None):
                with span("pool.launch"), torch.inference_mode():
                    copy = self._launch_chunk()
                count("pool.chunks")
                count("pool.slot_steps", self.num_slots * self.sync_every)
                for i in busy:
                    self._t_host[i] += self.sync_every
                nxt = (copy, [(i, self._keys[i], self._epoch[i]) for i in busy])

            if inflight is not None:
                copy, snapshot = inflight
                with span("pool.harvest"):
                    finished = self._harvest_chunk(copy, snapshot, cap)
                yield from finished
            inflight = nxt


class ContinuousGreedyDecoder(_SlotPoolBase):
    """Greedy slot pool over ``(key, B=1 batch)`` requests; ``run`` yields
    ``(key, tokens)`` in completion order.  ``prefill_len`` is the pool's
    merged-prefill bucket; a longer request raises ``ValueError``.  The
    pool's cache has capacity ``prefill_len + max_new_tokens``: a slot writes
    cell ``prefill_len + gen - 1`` with ``gen <= max_new_tokens``, and a
    finished slot keeps writing that same cell, so no write leaves it.

    On a CUDA device the chunk is a CUDA graph (``graph``), captured once
    here and replayed by each launch; counters ``pool.graph_captures`` and
    ``pool.graph_replays``.  On the CPU ``graph`` is None and the chunk
    runs eagerly."""

    def __init__(self, model, *, num_slots: int = 8, prefill_len: int,
                 max_new_tokens: int = 200, eos_token_id: int, sync_every: int = 8,
                 kv_bits: int = 16, merge: Optional[Merge] = None, device="cuda"):
        self._setup(model, num_slots=num_slots, prefill_len=prefill_len,
                    max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
                    sync_every=sync_every, kv_bits=kv_bits, merge=merge, device=device)
        self.capacity = prefill_len + max_new_tokens
        with torch.inference_mode():
            self.pool = _init_pool(self.llm, num_slots, self.capacity, sync_every,
                                   eos_token_id, self.dtype, kv_bits, self.dev)
        self.graph = self._capture() if self.dev.type == "cuda" else None

    def _steps(self) -> None:
        _pool_steps(self.llm, self.pool, eos_token_id=self.eos, max_new_tokens=self.max_new)

    def _capture(self):
        """One chunk recorded as a CUDA graph, the pool idle: every slot is
        inactive, so the warm-up chunk and the recorded one change no mask,
        offset, position, count or token, and write only each slot's cache
        cell 0, which a refill's :func:`install_rows` overwrites.  The
        warm-up runs the chunk's lazy set-up (library handles, workspaces)
        on the capture's own stream before the recording."""
        stream = torch.cuda.Stream(self.dev)
        stream.wait_stream(torch.cuda.current_stream(self.dev))
        graph = torch.cuda.CUDAGraph()
        with torch.inference_mode():
            with torch.cuda.stream(stream):
                self._steps()
            with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                self._steps()
        torch.cuda.current_stream(self.dev).wait_stream(stream)
        count("pool.graph_captures")
        return graph

    def _insert_chunk(self, slots, embeds, mask, pos, *, k, extra, offset):
        _insert_slots(self.llm, self.pool, slots, embeds, mask, pos,
                      eos_token_id=self.eos, kv_bits=self.kv_bits)

    def _launch_chunk(self) -> HostCopy:
        """A chunk (the graph's replay, or :func:`_pool_steps` eagerly),
        then the host copy of (tokens [steps, slots], tok0, fresh) taken
        before the tok0 channel is cleared."""
        p = self.pool
        if self.graph is not None:
            self.graph.replay()
            count("pool.graph_replays")
        else:
            self._steps()
        copy = HostCopy(p.toks, p.tok0_buf, p.tok0_fresh)
        p.tok0_fresh.zero_()
        return copy

    def _harvest_chunk(self, copy: HostCopy, snapshot, cap) -> list:
        toks, tok0, fresh = copy.get()
        finished = []
        for slot, key, epoch in snapshot:
            if self._keys[slot] != key or self._epoch[slot] != epoch:
                continue        # finished and refilled: a stale column
            if fresh[slot]:
                # the prefill token of a slot inserted just before the launch
                self._toks[slot].append(int(tok0[slot]))
            if self._toks[slot] and (self._toks[slot][-1] == self.eos
                                     or len(self._toks[slot]) >= cap(key)):
                finished.append(self._finish(slot, cap))
                continue
            for t in toks[:, slot]:
                self._toks[slot].append(int(t))
                if t == self.eos:
                    break
            self._emit_partial(slot, cap)
            if self._toks[slot][-1] == self.eos or len(self._toks[slot]) >= cap(key):
                finished.append(self._finish(slot, cap))
        return finished


def _init_pool(llm, num_slots: int, capacity: int, steps: int, eos: int, dtype, kv_bits: int,
               dev):
    """The greedy pool: the LLM's cache, per-slot state and a chunk's tokens
    [steps, slots] on the device, each written in place from then on."""
    def ints(fill=0):
        return torch.full((num_slots,), fill, dtype=torch.long, device=dev)
    return SimpleNamespace(
        cache=llm.init_cache(num_slots, capacity, dtype=dtype, device=dev, kv_bits=kv_bits),
        full_mask=torch.zeros(num_slots, capacity, dtype=torch.bool, device=dev),
        positions=ints(), write_idx=ints(), last_tok=ints(eos),
        active=torch.zeros(num_slots, dtype=torch.bool, device=dev), gen=ints(),
        tok0_buf=ints(eos), tok0_fresh=torch.zeros(num_slots, dtype=torch.bool, device=dev),
        toks=torch.full((steps, num_slots), eos, dtype=torch.long, device=dev),
    )


def _insert_slots(llm, pool, slots, embeds, attn_mask, position_ids, *, eos_token_id: int,
                  kv_bits: int) -> None:
    """Prefill k requests in one B=k forward and install each in its slot;
    the first tokens stay on the device (``tok0``)."""
    logits, cachek = prefill_rows(llm, embeds, attn_mask, position_ids, kv_bits)
    tok0 = logits.argmax(dim=-1)
    s = embeds.shape[1]
    install_rows(pool.cache, cachek, slots)
    pool.full_mask[slots] = F.pad(attn_mask.bool(), (0, pool.full_mask.shape[1] - s))
    pool.positions[slots] = position_ids[:, -1] + 1
    pool.write_idx[slots] = s
    pool.last_tok[slots] = tok0
    pool.active[slots] = tok0 != eos_token_id
    pool.gen[slots] = 1
    pool.tok0_buf[slots] = tok0
    pool.tok0_fresh[slots] = True


def _pool_steps(llm, pool, *, eos_token_id: int, max_new_tokens: int) -> None:
    """A chunk: one-token steps over the whole pool, one a row of
    ``pool.toks``; inactive slots emit EOS and stay frozen.  Writes only
    into the pool's tensors, in place, and never waits on the device: the
    function a CUDA graph records."""
    n = pool.full_mask.shape[0]
    rows = torch.arange(n, device=pool.full_mask.device)
    for st in range(pool.toks.shape[0]):
        # expose the cell about to be written, for active slots
        pool.full_mask[rows, pool.write_idx] |= pool.active
        hidden, _ = llm(llm.embed(pool.last_tok[:, None]), attention_mask=pool.full_mask,
                        position_ids=pool.positions[:, None], cache=pool.cache,
                        cache_index=pool.write_idx)
        nxt = llm.unembed(hidden)[:, 0].argmax(dim=-1)
        nxt = torch.where(pool.active, nxt, eos_token_id)
        step = pool.active.long()
        pool.write_idx += step
        pool.positions += step
        pool.gen += step
        pool.active &= (nxt != eos_token_id) & (pool.gen < max_new_tokens)
        pool.last_tok.copy_(nxt)
        pool.toks[st] = nxt


def decode_continuous(model, batches: Iterator[Tuple[str, Dict]], *, prefill_len: int,
                      max_new_tokens: int = 200, eos_token_id: int, num_slots: int = 8,
                      sync_every: int = 8, kv_bits: int = 16, device="cuda"):
    """Decode an iterator of ``(key, B=1 batch)`` with a greedy pool."""
    dec = ContinuousGreedyDecoder(
        model, num_slots=num_slots, prefill_len=prefill_len, max_new_tokens=max_new_tokens,
        eos_token_id=eos_token_id, sync_every=sync_every, kv_bits=kv_bits, device=device)
    return dec.run(batches)
