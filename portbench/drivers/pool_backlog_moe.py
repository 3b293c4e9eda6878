"""Serving cells of a DeepSeek-V3 LLM (latent attention, routed experts):
``pool_backlog``'s backlog through the recipe's slot pool
(``make_pool_decoder(...).run``), with the weights of
``weights_deepseek_v3.py`` and the reference of
``reference/deepseek_v3.py``.

As ``pool_backlog``: a request's cap is its transcript's tokens + 1, the
window opens once the pool's slots have turned over once, and
``decode_audio_s_per_s`` is the audio seconds of every request that
``run()`` yielded in it, over it.  The set-up's peak memory (the weights
drawn beside the model they are loaded into) is kept apart
(``readings["build_peak_gib"]``); the run's peak is the serving's, from
the end of the build.

What the pool served each request from is recorded as it serves
(:class:`Served`): the valid rows of its prefill (the merged prompt's
embeddings, positions and each MoE layer's chosen experts), and the
chosen experts of every decode step that read one of its tokens, which
the captured chunk leaves in the route tensors its capture recorded.
Every expert is drawn on its own, so a near-tie in a router that bf16
rounding flips swaps in an unrelated function; the reference is
therefore held to the served path's own choices, and the choices are
held to the reference's router apart.  On a sample of the window's
requests (``pool_backlog._sample``):

* ``served_gap``: how far each served token's logit (and the EOS's, for
  a request that stopped before its cap) lies below the best of the
  reference's float32 logits, over the served merged prompt and tokens,
  each MoE layer taking the served path's chosen experts; the worst
  token, as ``pool_backlog``'s check;
* ``route_margin``: the largest :func:`reference.deepseek_v3.deficit` of
  a served set against the reference's own top 6 at that position and
  layer, in router score (sigmoid + correction bias): a set that differs
  only where two scores lie within rounding of each other reads near 0,
  a wrong router (another k, another score, the bias in the weights of
  the choice) far above it.

Readings: ``route_flips`` (the share of (position, MoE layer) pairs whose
served set differs from the reference's top 6), the mean and 90th
percentile gap, and how the served merged prompts compare with the
reference's own front half (``prompt_same_length``: the share of the
sample whose reference prompt has the served length; the PSD's segments
move with the encoder's rounding, and the front half is held end to end
by ``tasu15.decode_backlog``).

``--control fp8`` puts in the served tokens' and sets' place those of
the reference with every LLM projection and expert weight rounded to
e4m3 (one scale per output row), routing on its own over the same
prompt and tokens: a path one step below bf16, which ``served_gap``'s
limit must refuse.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List

import numpy as np

from portbench import feed, harness, traffic, weights, weights_deepseek_v3
from portbench.drivers.pool_backlog import _sample
from portbench.harness import Check, Run, span


def run(r: Run) -> None:
    import torch

    # a program without the decoder fails here, before 32 GB of weights are drawn
    from ps_slm_tpu_torch.models import deepseek_v3  # noqa: F401

    from ps_slm_tpu_torch.data.dataset import Collator, MultiTaskDataset
    from ps_slm_tpu_torch.data.tokenizer import load_tokenizer
    from ps_slm_tpu_torch.inference import make_pool_decoder

    if r.control not in (None, "fp8"):
        raise ValueError(f"no control {r.control!r} for this serving cell")
    dev = torch.device(r.device)
    if dev.type == "cuda":
        from ps_slm_tpu_torch import _build

        _build.build_all()
    cfg, mix, recipe = r.cfg, r.mix, r.recipe
    utts = traffic.utterances(mix, r.seed, dev)
    by_key = {u.key: u for u in utts}
    paths = feed.write(r.workdir, cfg, utts, "test")
    cmvn = weights.cmvn(cfg, r.seed, dev)
    w = weights_deepseek_v3.make(cfg, r.seed, dev)
    model, tc, dc = harness.build_tasu(cfg, recipe, r.seed, w, cmvn, dev,
                                       decode_slots=mix["slots"])
    del w
    harness.free(dev)
    if dev.type == "cuda":
        r.readings["build_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
    tokenizer = load_tokenizer(paths["tokenizer"])
    model.speech_token_id, model.pad_token_id = tokenizer.speech_token_id, tokenizer.pad_token_id
    dc.test_scp_file_path = paths["data"]
    dc.multitask_prompt_path = feed.PROMPTS
    coll = Collator(tokenizer, dc, inference_mode=True)
    passes = int(mix.get("passes", 64))
    caps = {f"{u.key}.{c}": len(u.text) + 1 for u in utts for c in range(passes)}
    pulled: Dict[str, float] = {}

    def requests():
        for c in range(passes):
            for sample in MultiTaskDataset(dc, tokenizer, "test", seed=r.seed + c):
                batch = {k: torch.from_numpy(v).to(dev) for k, v in coll([sample]).items()
                         if isinstance(v, np.ndarray)}
                key = f"{sample.key}.{c}"
                pulled[key] = time.perf_counter()
                yield key, batch

    log: List = []
    model.llm.set_routes(log)             # before the pool captures its chunk
    dec = make_pool_decoder(model, tc, dc, eos_token_id=tokenizer.eos_token_id, device=dev)
    served = Served(dec, log, cfg["llm"])
    gen = dec.run(requests(), stop_after=caps)
    for _ in range(tc.decode_slots):           # the pool's first turnover
        next(gen)
    r.setup_done()

    seconds = min(r.seconds, mix["trace_seconds"]) if r.trace else r.seconds
    done: List = []
    with harness.traced(r), span("window"):
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while True:
            with span("pool.next"):
                key, toks = next(gen)
            t = time.perf_counter()
            done.append((key, [int(x) for x in toks], t))
            if t >= deadline:
                break
        t_end = t
    gen.close()
    harness.sync(dev)
    window = t_end - t_start
    audio = sum(by_key[k.rsplit(".", 1)[0]].seconds for k, _, _ in done)
    r.e2e["decode_audio_s_per_s"] = audio / window
    r.attempted = len(done)
    r.failed = sum(len(t) > caps[k] for k, t, _ in done)
    r.mem_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    in_slot = sum(t - pulled[k] for k, _, t in done)
    r.facts.update(window_s=window, tokens=sum(len(t) for _, t, _ in done), in_slot_s=in_slot,
                   slots=tc.decode_slots, weight_bits=16)
    prefilled = [k for k, t in pulled.items() if t_start <= t <= t_end]
    sample = _sample(done, r.seed, r.mix["sample_tokens"])
    records = {key: served.record(key, len(toks)) for key, toks, _ in sample}
    model.llm.set_routes(None)
    served.close()
    del dec, gen, model, served, log
    harness.free(dev)
    _compare(r, done, sample, prefilled, by_key, caps, tokenizer.eos_token_id, cmvn, records)


class _HostCopy:
    """A device tensor copied to pinned host memory behind the work that
    made it, and an event after; :meth:`get` waits on that event only."""

    def __init__(self, t):
        import torch

        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t.clone()

    def get(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class Served:
    """What a greedy slot pool served each request from, recorded through
    the model's route hook (``DeepseekV3Model.set_routes``, which appends
    each MoE layer's chosen experts to ``log``) and the pool's own
    hand-offs, each wrapped on this one decoder:

    * ``_insert_chunk``: each prefilled row's valid positions: the merged
      prompt's embeddings and positions and the MoE layers' sets;
    * ``_reset_slot``: the key the row's slot now serves;
    * ``_launch_chunk``: the chunk's sets [steps, layers, slots, k], from
      the route tensors the capture recorded (the replay rewrites them) or,
      for an eager chunk, from those it appended; copied to the host
      without a wait;
    * ``_harvest_chunk``: each live slot's column of the chunk's sets, for
      the same (slot, key, epoch) whose tokens the harvest reads.

    Step ``i`` of a request's steps read its served token ``i``."""

    def __init__(self, dec, log: List, llm_cfg: Dict):
        self.dec, self.log = dec, log
        self.layers = llm_cfg["num_hidden_layers"] - llm_cfg["first_k_dense_replace"]
        per_chunk = dec.sync_every * self.layers
        self.graph_routes = list(log[-per_chunk:]) if dec.graph is not None else None
        log.clear()
        self.prompts: Dict[str, tuple] = {}
        self.steps: Dict[str, List[np.ndarray]] = {}
        self._pending: Dict[int, tuple] = {}
        self._chunks: collections.deque = collections.deque()
        self._wrap("_insert_chunk", self._on_insert)
        self._wrap("_reset_slot", self._on_reset)
        self._wrap("_launch_chunk", self._on_launch)
        self._wrap("_harvest_chunk", self._on_harvest)

    def _wrap(self, name: str, hook) -> None:
        inner = getattr(self.dec, name)
        setattr(self.dec, name, lambda *a, **kw: hook(inner, *a, **kw))

    def _on_insert(self, inner, slots, embeds, mask, pos, **kw):
        import torch

        n0 = len(self.log)
        inner(slots, embeds, mask, pos, **kw)
        k, s = mask.shape
        sets = torch.stack(self.log[n0:], 1).view(k, s, self.layers, -1)
        del self.log[n0:]
        valid = mask.bool()
        lengths = valid.sum(1).tolist()
        parts = [x[valid].cpu().split(lengths) for x in (embeds, pos, sets.to(torch.int16))]
        for slot, e, p, r in zip(slots.tolist(), *parts):
            self._pending[slot] = (e, p, r.numpy())

    def _on_reset(self, inner, slot, key):
        inner(slot, key)
        if slot in self._pending:
            self.prompts[key] = self._pending.pop(slot)
            self.steps[key] = []

    def _on_launch(self, inner):
        import torch

        n0 = len(self.log)
        copy = inner()
        fresh = self.log[n0:] if len(self.log) > n0 else self.graph_routes
        sets = torch.stack(fresh).view(self.dec.sync_every, self.layers, self.dec.num_slots, -1)
        del self.log[n0:]
        self._chunks.append(_HostCopy(sets.to(torch.int16)))
        return copy

    def _on_harvest(self, inner, copy, snapshot, cap):
        live = [(slot, key) for slot, key, epoch in snapshot
                if self.dec._keys[slot] == key and self.dec._epoch[slot] == epoch
                and key in self.steps]
        finished = inner(copy, snapshot, cap)     # waits on the chunk in its own span
        sets = self._chunks.popleft().get()
        for slot, key in live:
            self.steps[key].append(sets[:, :, slot])
        return finished

    def record(self, key: str, n_tokens: int) -> tuple:
        """(prompt embeddings [P, H], positions [P], the sets of the prompt
        and of the first ``n_tokens`` served tokens' positions [P + n, layers,
        k] and which of those rows were recorded [P + n])."""
        import torch

        embeds, pos, prompt_sets = self.prompts[key]
        steps = (np.concatenate(self.steps[key])[:n_tokens] if self.steps[key]
                 else prompt_sets[:0])
        kk = prompt_sets.shape[-1]
        tail = np.zeros((n_tokens - len(steps), self.layers, kk), dtype=prompt_sets.dtype)
        sets = torch.from_numpy(np.concatenate([prompt_sets, steps, tail]).astype(np.int64))
        forced = torch.zeros(sets.shape[0], dtype=torch.bool)
        forced[:len(prompt_sets) + len(steps)] = True
        return embeds, pos, sets, forced

    def close(self) -> None:
        """Let go of the decoder and the captured route tensors."""
        self.graph_routes = None
        self._chunks.clear()
        self.dec = None


def _compare(r: Run, done: List, sample: List, prefilled: List, by_key: Dict, caps: Dict,
             eos: int, cmvn, records: Dict) -> None:
    import torch

    from portbench import reference
    from portbench.reference import deepseek_v3 as ref
    from portbench.reference import frontend, tasu

    reference.strict_fp32()
    dev = torch.device(r.device)
    w = weights_deepseek_v3.make(r.cfg, r.seed, dev)          # the LLM stays bf16
    w["encoder"], w["projector"] = weights.fp32(w["encoder"]), weights.fp32(w["projector"])
    w_llm, llm_cfg = w["llm"], r.cfg["llm"]
    thr = r.recipe["blank_threshold"]
    all_gaps, deficits, shares, same = [], [], [], []
    with torch.no_grad():
        for key, toks, _ in sample:
            u = by_key[key.rsplit(".", 1)[0]]
            row = feed.reference_row(u, r.recipe, train=False, device=dev)
            post = tasu.posterior(w["encoder"], r.cfg["encoder"], row, cmvn)
            shares.append(tasu.blank_share(post))
            prompt, pos, sets, forced = records[key]
            prompt = prompt.to(dev)
            table = {"embed_tokens.weight": w_llm["embed_tokens.weight"]}
            audio = tasu.project(w["projector"], tasu.psd(post, threshold=thr))
            own = tasu.merged(table, row, audio.to(table["embed_tokens.weight"].dtype)).float()
            same.append(own.shape[0] == prompt.shape[0])
            if r.control == "fp8":
                got: List = []
                with ref.fp8_weights():
                    check = ref.served_logits(w_llm, llm_cfg, prompt, pos, toks,
                                              routes=got).argmax(-1).tolist()
                sets, forced = torch.stack(got, 1), None
            else:
                check = list(toks) + ([eos] if len(toks) < caps[key] else [])
            defs: List = []
            lg = ref.served_logits(w_llm, llm_cfg, prompt, pos, toks, force=sets.to(dev),
                                   forced=None if forced is None else forced.to(dev),
                                   deficits=defs)
            all_gaps.append(tasu.gaps(lg, check).float().cpu())
            deficits.append(torch.cat(defs).cpu())
        if r.trace:
            def facts(keys):
                reqs = []
                for key in keys:
                    u = by_key[key.rsplit(".", 1)[0]]
                    row = feed.reference_row(u, r.recipe, train=False, device=dev)
                    post = tasu.posterior(w["encoder"], r.cfg["encoder"], row, cmvn)
                    reqs.append({"enc": frontend.n_lfr(len(u.samples)) + len(tasu.QUERY_IDS),
                                 "kept": len(tasu.psd_segments(post, threshold=thr)),
                                 "text": len(row.prompt)})
                return reqs
            r.facts["requests"] = [dict(f, tokens=len(toks)) for f, (_, toks, _) in
                                   zip(facts([k for k, _, _ in done]), done)]
            r.facts["prefills"] = facts(prefilled)
    del w, w_llm
    harness.free(dev)
    gaps, d = torch.cat(all_gaps), torch.cat(deficits)
    r.readings.update(blank_share=float(np.mean(shares)), compared_tokens=int(gaps.numel()),
                      served_gap_mean=float(gaps.mean()),
                      served_gap_p90=float(torch.quantile(gaps, 0.9)),
                      route_flips=float((d > 0).float().mean()), route_pairs=int(d.numel()),
                      prompt_same_length=float(np.mean(same)))
    r.checks["served_gap"] = Check(float(gaps.max()), r.mix["limits"]["served_gap"])
    r.checks["route_margin"] = Check(float(d.max()), r.mix["limits"]["route_margin"])
    r.checks["over_cap"] = Check(float(r.failed), 0.0)
