"""The traffic as each side sees it.

To the port: the stand-in assets and a manifest under the run's work
directory, read by the port's own dataset, tokenizer and collator, as its
CLIs read a recipe's data.  To the reference: the same utterances, with
the prompt and target tokenized by the reference's tokenizer, and the
dynamic batching worked out again by the rule the recipe states (close a
batch when ``(n + 1) * its largest cost`` would pass the budget, a row's
cost its tokens plus its LFR frames / ``ds_rate`` less one).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List

from portbench import assets, traffic
from portbench.reference import frontend
from portbench.reference.tasu import Row

PROMPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "multiprompt.jsonl")


def write(workdir: str, cfg: Dict, utts: List[traffic.Utterance], split: str) -> Dict[str, str]:
    """Tokenizer directory, BPE model and ``<split>/multitask.jsonl`` over a
    wav ark; returns their paths."""
    tok = assets.write_llm_tokenizer(os.path.join(workdir, "llm"))
    enc = assets.write_bpe_model(os.path.join(workdir, "encoder"), cfg["encoder"]["vocab_size"])
    data = os.path.join(workdir, split)
    os.makedirs(data, exist_ok=True)
    ark = os.path.join(data, "wav.ark")
    offsets = assets.write_wav_ark(ark, ((u.key, u.samples) for u in utts))
    assets.write_manifest(data, ({"key": u.key, "path": f"{ark}:{offsets[u.key]}",
                                  "target": u.text, "GT": u.text, "task": "ASR"} for u in utts))
    return {"tokenizer": tok, "encoder": enc, "data": data}


def prompt_text(recipe: Dict) -> str:
    import json

    with open(PROMPTS) as f:
        prompt = json.loads(f.readline())["prompt"]
    return recipe["dataset_config"]["prompt_style"].format(prompt)


def reference_row(u: traffic.Utterance, recipe: Dict, train: bool, noise=None, device="cpu"
                  ) -> Row:
    import torch

    prompt = assets.token_ids(prompt_text(recipe))
    target = []
    if train:
        text = re.sub(r"[^A-Za-z\s.,!?']+", "", u.text).lower().strip()
        target = assets.token_ids(text) + [assets.SPECIAL_IDS[assets.EOS]]
    return Row(torch.as_tensor(u.samples, device=device), prompt,
               prompt.index(assets.SPECIAL_IDS[assets.SPEECH_TOKEN]), target, noise)


def reference_batches(utts: List[traffic.Utterance], recipe: Dict, budget: int, ds_rate: int
                      ) -> List[List[str]]:
    """The keys of each batch of one epoch, by the recipe's rule."""
    out, buf, cur = [], [], 0
    for u in utts:
        row = reference_row(u, recipe, train=True)
        cost = len(row.prompt) + len(row.target) + frontend.n_lfr(len(u.samples)) // ds_rate - 1
        new = max(cur, cost)
        if buf and (len(buf) + 1) * new > budget:
            out.append(buf)
            buf, cur = [u.key], cost
        else:
            buf.append(u.key)
            cur = new
    if buf:
        out.append(buf)
    return out
