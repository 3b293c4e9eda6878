"""The one general generator of the benchmark's traffic.

A traffic mix is ``traffic/<mix>.json``: its generator ``kind``
(``train_stream``, ``pool_backlog`` or ``asr_backlog``, each a driver in
``drivers/``), the recipe of the configuration it runs, and the
parameters read here:

* ``utterances``: how many distinct utterances the run's pool holds (the
  stream cycles over them, epoch after epoch, as a training run does);
* ``seconds``: [lo, hi], durations log-uniform between them;
* ``tokens_per_second``: transcript length in LLM tokens per audio second
  (the stand-in tokenizer is byte-level, so characters);
* ``warm_first``: put one utterance of each bucket of ``bucket_seconds``
  first, so that the set-up meets every shape the window will;
* ``burst_duty``: the share of time in syllable-like bursts; the rest is
  pauses, which the calibrated CTC head marks blank (``weights.py``).

Every seed gets the same set of durations (the quantiles of the
distribution, one an utterance) and transcript lengths, in another order,
and its own waveforms and words: the work is the same from seed to seed.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
RATE = 16000
WORDS = ("the cat sat on a mat while rain fell over quiet hills and old ships sailed past "
         "bright towers into the evening sea we went home late after a long day of work").split()


def load(kind: str, name: str) -> Dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


@dataclass
class Utterance:
    key: str
    samples: np.ndarray      # int16 [n]
    text: str                # lower-case words, ``len(text)`` LLM tokens

    @property
    def seconds(self) -> float:
        return len(self.samples) / RATE


def durations(n: int, lo: float, hi: float, rng: np.random.Generator) -> np.ndarray:
    """The n quantiles of log-uniform [lo, hi], in an order drawn from rng."""
    q = (np.arange(n) + 0.5) / n
    return np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))[rng.permutation(n)]


def transcript(n_chars: int, rng: np.random.Generator) -> str:
    """Words of WORDS joined by spaces, cut to exactly ``n_chars``
    characters (at least one word, no trailing space)."""
    words: List[str] = []
    while sum(len(w) + 1 for w in words) <= n_chars:
        words.append(str(rng.choice(WORDS)))
    text = " ".join(words)[:max(n_chars, 1)]
    return text[:-1] + "s" if text.endswith(" ") else text


def _warm_first(durs: np.ndarray, bucket: float) -> np.ndarray:
    """An order of the durations with the first of each bucket up front."""
    order, first, seen = list(range(len(durs))), [], set()
    for i in order:
        b = int(durs[i] // bucket)
        if b not in seen:
            seen.add(b)
            first.append(i)
    rest = [i for i in order if i not in set(first)]
    return np.asarray(first + rest)


def synthesize(lens: np.ndarray, gen: torch.Generator, device, duty: float) -> torch.Tensor:
    """int16 waveforms of ``lens`` samples laid end to end: syllable-like
    bursts (a tone and white noise) at 4-6 a second, ``duty`` of the time,
    between pauses of faint noise; each utterance its own tone, rate and
    phase."""
    dev = torch.device(device)
    n = len(lens)
    starts = torch.as_tensor(np.concatenate([[0], np.cumsum(lens)[:-1]]), device=dev)
    utt = torch.repeat_interleave(torch.arange(n, device=dev), torch.as_tensor(lens, device=dev))
    t = (torch.arange(int(np.sum(lens)), device=dev) - starts[utt]).double() / RATE
    params = torch.rand((3, n), generator=gen, device=dev, dtype=torch.float64)
    tone = 100.0 + 300.0 * params[0][utt]
    burst = torch.remainder(t * (4.0 + 2.0 * params[1][utt]) + params[2][utt], 1.0) < duty
    noise = torch.randn(t.numel(), generator=gen, device=dev, dtype=torch.float32).double()
    wave = torch.where(burst, 0.1 * torch.sin(2 * math.pi * tone * t) + 0.05 * noise, 0.002 * noise)
    return torch.clamp(torch.round(wave * 32767.0), -32768, 32767).to(torch.int16)


def utterances(mix: Dict, seed: int, device) -> List[Utterance]:
    """The run's pool of utterances (module docstring), drawn on ``device``
    in one pass (:func:`synthesize`)."""
    n = int(mix["utterances"])
    rng = np.random.default_rng(seed)
    durs = durations(n, *mix["seconds"], rng)
    if mix.get("warm_first"):
        durs = durs[_warm_first(durs, float(mix["bucket_seconds"]))]
    lens = np.maximum((durs * RATE).astype(np.int64), 400)
    texts = [transcript(int(round(mix["tokens_per_second"] * d)), rng) for d in durs]
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    pcm = synthesize(lens, gen, device, mix.get("burst_duty", 0.3)).cpu().numpy()
    cuts = np.cumsum(lens)[:-1]
    return [Utterance(f"u{i:05d}", s, txt) for i, (s, txt) in enumerate(zip(np.split(pcm, cuts), texts))]


def probe(seed: int, device, seconds: float = 8.0, duty: float = 0.3):
    """One utterance of :func:`synthesize` and, for each of its LFR frames,
    whether the frame's centre lies in a burst: what the benchmark's CTC
    head is calibrated on (``weights.py``)."""
    gen = torch.Generator(device=device).manual_seed((seed * 31 + 7) % (2 ** 63))
    lens = np.asarray([int(seconds * RATE)])
    gen_state = gen.get_state()
    pcm = synthesize(lens, gen, device, duty)
    params = torch.rand((3, 1), generator=torch.Generator(device=device).set_state(gen_state),
                        device=device, dtype=torch.float64)
    frames = -(-max(1 + (int(lens[0]) - 400) // 160, 0) // 6)
    centre = (torch.arange(frames, device=device, dtype=torch.float64) * 960 + 200) / RATE
    burst = torch.remainder(centre * (4.0 + 2.0 * params[1, 0]) + params[2, 0], 1.0) < duty
    return pcm, burst
