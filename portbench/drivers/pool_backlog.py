"""Serving cells: the recipe's slot pool (``make_pool_decoder(...).run``)
over a backlog that always has a request ready, each request built as
``cli/decode.py::_decode_continuous`` builds it (the port's dataset and
collator, one B=1 batch on the card).  The utterances cycle, each pass
with fresh prompts' draws and keys.

A request's cap (``stop_after``) is its transcript's tokens + 1, standing
in for the EOS a trained model would emit.  The window opens once the
pool's slots have turned over once; ``decode_audio_s_per_s`` is the audio
seconds of every request that ``run()`` yielded in it, over it.

Correctness: a sample of the requests finished in the window, drawn from
the seed with the longest among them, until ``sample_tokens`` served
tokens; the reference runs each prompt with its served tokens and reads
how far each served token's logit lies below its best (and the EOS's, for
a request that stopped before its cap).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from portbench import feed, harness, traffic, weights
from portbench.harness import Check, Run, span


def run(r: Run) -> None:
    import torch

    from ps_slm_tpu_torch.data.dataset import Collator, MultiTaskDataset
    from ps_slm_tpu_torch.data.tokenizer import load_tokenizer
    from ps_slm_tpu_torch.inference import make_pool_decoder

    dev = torch.device(r.device)
    if dev.type == "cuda":
        from ps_slm_tpu_torch import _build

        _build.build_all()
    cfg, mix, recipe = r.cfg, r.mix, r.recipe
    utts = traffic.utterances(mix, r.seed, dev)
    by_key = {u.key: u for u in utts}
    paths = feed.write(r.workdir, cfg, utts, "test")
    cmvn = weights.cmvn(cfg, r.seed, dev)
    w = weights.make(cfg, r.seed, dev)
    model, tc, dc = harness.build_tasu(cfg, recipe, r.seed, w, cmvn, dev,
                                       decode_slots=mix["slots"])
    del w
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

    dec = make_pool_decoder(model, tc, dc, eos_token_id=tokenizer.eos_token_id, device=dev)
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
                   slots=tc.decode_slots, weight_bits=tc.quant_bits)
    del dec, gen, model
    harness.free(dev)
    sample = _sample(done, r.seed, r.mix["sample_tokens"])
    control = None
    if r.control == "int4":
        control = _int4_choices(r, sample, cmvn, dc, coll, tokenizer)
    elif r.control:
        raise ValueError(f"no control {r.control!r} for a serving cell")
    _compare(r, done, sample, by_key, caps, tokenizer.eos_token_id, cmvn, control)


def _int4_choices(r: Run, sample: List, cmvn, dc, coll, tokenizer) -> Dict[str, List[int]]:
    """The control: the program with its int4 path on, read at each
    position of the sampled prompts and their served tokens; its first
    choice there."""
    import torch

    from ps_slm_tpu_torch.data.dataset import MultiTaskDataset
    from ps_slm_tpu_torch.models.tasu import prepare_merged

    dev = torch.device(r.device)
    w = weights.make(r.cfg, r.seed, dev)
    model, *_ = harness.build_tasu(r.cfg, r.recipe, r.seed, w, cmvn, dev, quant_bits=4)
    del w
    model.speech_token_id, model.pad_token_id = tokenizer.speech_token_id, tokenizer.pad_token_id
    out = {}
    with torch.inference_mode():
        for key, toks, _ in sample:
            base, c = key.rsplit(".", 1)
            ds = MultiTaskDataset(dc, tokenizer, "test", seed=r.seed + int(c))
            s = next(x for x in ds if x.key == base)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in coll([s]).items()
                     if isinstance(v, np.ndarray)}
            m = prepare_merged(model, batch, left_padding=True, generate_mode=True)
            ids = torch.as_tensor([toks], device=dev, dtype=torch.long)
            emb = torch.cat([m.embeds, model.llm.embed(ids)], dim=1)
            mask = torch.cat([m.attention_mask, torch.ones_like(ids, dtype=torch.bool)], dim=1)
            last = m.position_ids[:, -1:]
            pos = torch.cat([m.position_ids, last + 1 + torch.arange(ids.shape[1], device=dev)], 1)
            hidden, _ = model.llm(emb, mask, pos)
            lg = model.llm.unembed(hidden[:, m.embeds.shape[1] - 1:])
            out[key] = lg[0].argmax(dim=-1).tolist()
    del model
    harness.free(dev)
    return out


def _sample(done: List, seed: int, want: int) -> List:
    """The longest request, then others drawn from the seed, until ``want``
    served tokens."""
    rng = np.random.default_rng(seed)
    order = sorted(range(len(done)), key=lambda i: -len(done[i][1]))
    picked, tokens = [order[0]], len(done[order[0]][1])
    for i in rng.permutation(len(done)):
        if tokens >= want:
            break
        if i not in picked:
            picked.append(int(i))
            tokens += len(done[i][1])
    return [done[i] for i in picked]


def _compare(r: Run, done: List, sample: List, by_key: Dict, caps: Dict, eos: int, cmvn,
             control=None) -> None:
    import torch

    from portbench import reference
    from portbench.reference import frontend, llm, tasu

    reference.strict_fp32()
    dev = torch.device(r.device)
    w = {k: weights.fp32(v) for k, v in weights.make(r.cfg, r.seed, dev).items()}
    tc = r.recipe["train_config"]
    if tc.get("quantization") and tc.get("quant_bits") == 8:
        w["llm"] = llm.int8_weights(w["llm"], r.cfg["llm"])
    thr = r.recipe["blank_threshold"]
    worst, n_tok, shares = 0.0, 0, []
    with torch.no_grad():
        for key, toks, _ in sample:
            u = by_key[key.rsplit(".", 1)[0]]
            row = feed.reference_row(u, r.recipe, train=False, device=dev)
            shares.append(tasu.blank_share(tasu.posterior(w["encoder"], r.cfg["encoder"], row,
                                                          cmvn)))
            lg = tasu.served_logits(w, r.cfg, row, toks, cmvn, thr)
            check = list(toks) + ([eos] if len(toks) < caps[key] else [])
            if control is not None:
                check = control[key][:len(toks) + 1]
            worst = max(worst, float(tasu.gaps(lg, check).max()))
            n_tok += len(check)
        if r.trace:
            reqs = []
            for key, toks, t in done:
                u = by_key[key.rsplit(".", 1)[0]]
                row = feed.reference_row(u, r.recipe, train=False, device=dev)
                post = tasu.posterior(w["encoder"], r.cfg["encoder"], row, cmvn)
                reqs.append({"enc": frontend.n_lfr(len(u.samples)) + len(tasu.QUERY_IDS),
                             "kept": len(tasu.psd_segments(post, threshold=thr)),
                             "text": len(row.prompt), "tokens": len(toks)})
            r.facts["requests"] = reqs
    del w
    harness.free(dev)
    r.readings.update(blank_share=float(np.mean(shares)), compared_tokens=n_tok)
    r.checks["served_gap"] = Check(worst, r.mix["limits"]["served_gap"])
    r.checks["over_cap"] = Check(float(r.failed), 0.0)
