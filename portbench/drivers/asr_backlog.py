"""Standalone ASR cells: SenseVoiceSmall's encoder alone, fed batches of
VAD-sized segments up to ``batch_seconds`` of audio (funasr
``AutoModel``'s ``batch_size_s``), each through ``ops/fbank.py::frontend``
(eval) and ``models/sensevoice_asr.py::inference`` with the recipe's
language, ITN, emotion ban and timestamps, until texts and timestamps
reach the host.  The segments cycle, batch after batch.

``asr_audio_s_per_s``: audio seconds of every batch whose results reached
the host in the window, over the window.

Correctness: a sample of the window's utterances drawn from the seed,
with the longest among them; the program's tokens are read back from its
text (the stand-in BPE model gives every label a piece of its own) and
its alignment from the timestamps, and judged against the reference
(``reference/asr.py``).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from portbench import assets, harness, traffic, weights
from portbench.harness import Check, Run, span

FRAME_MS = 60


def _batches(utts, seconds: float) -> List[List]:
    out, cur, total = [], [], 0.0
    for u in utts:
        if cur and total + u.seconds > seconds:
            out.append(cur)
            cur, total = [], 0.0
        cur.append(u)
        total += u.seconds
    return out + ([cur] if cur else [])


def _aligned(result: Dict, tokens: List[int]) -> List:
    """(token, first frame, end frame) of each timestamped token."""
    out = []
    for (piece, left, right), tok in zip(result.get("timestamp", []), tokens[4:]):
        a = 0 if left == 0 else int(round((left * 1000 + 30) / FRAME_MS))
        out.append((tok, a, int(round((right * 1000 + 30) / FRAME_MS))))
    return out


def _tokens(text: str) -> List[int]:
    return [int(p[1:]) for p in text.split()]


def run(r: Run) -> None:
    import torch

    from ps_slm_tpu_torch.config import FbankConfig
    from ps_slm_tpu_torch.data.spm import SenseVoiceTokenizer
    from ps_slm_tpu_torch.models.sensevoice import SenseVoiceConfig, SenseVoiceEncoder
    from ps_slm_tpu_torch.models.sensevoice_asr import inference
    from ps_slm_tpu_torch.ops.fbank import frontend

    dev = torch.device(r.device)
    if dev.type == "cuda":
        from ps_slm_tpu_torch import _build

        _build.build_all()
    cfg, mix, recipe = r.cfg, r.mix, r.recipe
    utts = traffic.utterances(mix, r.seed, dev)
    tok_dir = assets.write_bpe_model(r.workdir, cfg["encoder"]["vocab_size"], labels=True)
    tokenizer = SenseVoiceTokenizer(tok_dir)
    cmvn = weights.cmvn(cfg, r.seed, dev)
    w = weights.make(cfg, r.seed, dev, parts=("encoder",))["encoder"]
    widths = {k: v for k, v in cfg["encoder"].items() if k != "blank_id"}
    with torch.device("meta"):
        encoder = SenseVoiceEncoder(SenseVoiceConfig(**widths))
    encoder = encoder.to(dtype=weights.DTYPES[cfg["dtype"]]).to_empty(device=dev)
    encoder.load_state_dict(w)
    del w
    fb = FbankConfig(**recipe.get("fbank", {}))
    batches = _batches(utts, mix["batch_seconds"])

    def step(us):
        n = max(len(u.samples) for u in us)
        wave = np.zeros((len(us), n), np.int16)
        for i, u in enumerate(us):
            wave[i, :len(u.samples)] = u.samples
        lens = torch.as_tensor([len(u.samples) for u in us], dtype=torch.int32)
        feats, flens = frontend(torch.from_numpy(wave).to(dev), lens.to(dev), cfg=fb, cmvn=cmvn,
                                train=False)
        return inference(encoder, tokenizer, feats.to(weights.DTYPES[cfg["dtype"]]), flens,
                         language=recipe["language"], use_itn=recipe["use_itn"],
                         ban_emo_unk=recipe["ban_emo_unk"],
                         output_timestamp=recipe["output_timestamp"],
                         keys=[u.key for u in us], device=dev)

    for us in batches[:mix.get("warmup_batches", 1)]:
        step(us)
    r.setup_done()

    seconds = min(r.seconds, mix["trace_seconds"]) if r.trace else r.seconds
    done: Dict[str, Dict] = {}
    audio, n_batches, i = 0.0, 0, 0
    lengths: List[int] = []
    with harness.traced(r), span("window"):
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while True:
            us = batches[i % len(batches)]
            i += 1
            with span("asr.batch"):
                results = step(us)
            n_batches += 1
            audio += sum(u.seconds for u in us)
            for u, res in zip(us, results):
                done[u.key] = res
                lengths.append(u.samples.shape[0])
            if time.perf_counter() >= deadline:
                break
        t_end = time.perf_counter()
    window = t_end - t_start
    r.e2e["asr_audio_s_per_s"] = audio / window
    r.attempted = n_batches
    r.mem_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    from portbench.reference import frontend as ref_frontend

    r.facts.update(window_s=window,
                   asr_lengths=[ref_frontend.n_lfr(n) + 4 for n in lengths])
    del encoder
    harness.free(dev)
    _compare(r, utts, done, cmvn)


def _compare(r: Run, utts, done: Dict[str, Dict], cmvn) -> None:
    import torch

    from portbench import reference
    from portbench.reference import asr, precision

    reference.strict_fp32()
    dev = torch.device(r.device)
    w = weights.fp32(weights.make(r.cfg, r.seed, dev, parts=("encoder",))["encoder"])
    recipe = r.recipe
    banned = recipe["emo_unk_id"] if recipe["ban_emo_unk"] else None
    by_key = {u.key: u for u in utts}
    rng = np.random.default_rng(r.seed)
    keys = sorted(done, key=lambda k: -len(by_key[k].samples))[:1]
    keys += [k for k in rng.permutation(sorted(done)) if k not in keys][: r.mix["sample_utterances"] - 1]
    worst = {"greedy_gap": 0.0, "align_gap": 0.0}
    with torch.no_grad():
        for key in keys:
            samples = torch.as_tensor(by_key[key].samples, device=dev)
            lp = asr.log_probs(w, r.cfg["encoder"], samples, cmvn, recipe["query_ids"], banned)
            if r.control == "fp8":
                with precision.fp8():
                    tokens, aligned = asr.output(
                        asr.log_probs(w, r.cfg["encoder"], samples, cmvn, recipe["query_ids"],
                                      banned).cpu().numpy())
            elif r.control:
                raise ValueError(f"no control {r.control!r} for an ASR cell")
            else:
                tokens = _tokens(done[key]["text"])
                aligned = _aligned(done[key], tokens)
            got = asr.judge(lp.cpu().numpy(), tokens, aligned)
            for k, v in got.items():
                worst[k] = max(worst[k], v)
    lim = r.mix["limits"]
    r.readings.update(compared_utterances=len(keys))
    for k, v in worst.items():
        r.checks[k] = Check(v, lim[k])
