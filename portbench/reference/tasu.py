"""TASU (the CTC posterior of the speech, PSD, the linear-silu projector,
the merge into the LLM's prompt) and its training and serving, one row at
a time, float32.

* **Posterior**: softmax of the encoder's CTC logits, the four query
  frames dropped.
* **PSD** (posterior-synchronous downsampling): frames split into
  segments at every change of the argmax label, at each blank frame and
  after it; a segment whose mean blank probability reaches the threshold
  drops; each other becomes the mean of its frames.
* **Projector**: LayerNorm, linear to 2048, SiLU, linear to the LLM width.
* **Text-only**: in place of the posterior and PSD, the transcript's
  encoder-vocabulary ids as one-hot rows smoothed toward uniform, some
  dropped (CPS noise), from the draws the program was handed.
* **Merge**: the ``<speech>`` token of the prompt replaced by the pooled
  frames' projections; the target after the prompt.
* **Training**: cross-entropy of each target token (and the EOS after it)
  from the logits of the position before it, summed over the rows and
  divided by their count; the projector's gradient; AdamW as optax's
  ``adamw`` (bias-corrected moments, eps outside the root) with the
  linear warm-up's learning rate, each update stored in the parameters'
  dtype.
* **Serving**: teacher-forced logits of a prompt and its served tokens.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import encoder as enc
from portbench.reference import frontend, llm
from portbench.reference.encoder import layer_norm
from portbench.reference.precision import mm

QUERY_IDS = (0, 1, 2, 2)


@dataclass
class Row:
    """One utterance as the reference sees it: int16 samples, the prompt's
    token ids with the index of its ``<speech>`` token, the target's ids
    (EOS included; empty when serving) and the dither noise, if any."""
    samples: torch.Tensor
    prompt: List[int]
    speech_at: int
    target: List[int]
    noise: Optional[torch.Tensor] = None
    gt_ids: Optional[List[int]] = None       # text-only: the transcript in the encoder's vocabulary
    alpha: float = 0.0                       # text-only: the smoothing weight drawn for the row
    u_drop: Optional[torch.Tensor] = None    # text-only: a uniform a transcript token


def posterior(w_enc: Dict, cfg_enc: Dict, row: Row, cmvn, dither: float = 0.0,
              query_ids: Sequence[int] = QUERY_IDS) -> torch.Tensor:
    """[T, vocab] CTC posterior of the speech frames."""
    feats = frontend.features(row.samples, cmvn, dither, row.noise)
    _, logits = enc.encode(w_enc, cfg_enc, feats, query_ids)
    return torch.softmax(logits, dim=-1)[len(query_ids):]


def psd_segments(post: torch.Tensor, blank: int = 0, threshold: float = 0.9
                 ) -> List[Tuple[int, int]]:
    """[start, end) of each kept segment."""
    ids = post.argmax(dim=-1).cpu().numpy()
    pb = post[:, blank].double().cpu().numpy()
    kept, start = [], 0
    for t in range(1, len(ids) + 1):
        if t == len(ids) or ids[t] != ids[t - 1] or ids[t] == blank or ids[t - 1] == blank:
            if pb[start:t].mean() < threshold:
                kept.append((start, t))
            start = t
    return kept


def psd(post: torch.Tensor, blank: int = 0, threshold: float = 0.9) -> torch.Tensor:
    """[kept segments, vocab] means of the kept segments."""
    segs = psd_segments(post, blank, threshold)
    if not segs:
        return post[:0]
    return torch.stack([post[a:b].mean(dim=0) for a, b in segs])


def blank_share(post: torch.Tensor, blank: int = 0, threshold: float = 0.9) -> float:
    """Share of frames whose blank probability reaches the threshold."""
    return float((post[:, blank] >= threshold).float().mean())


def pseudo_posterior(row: Row, vocab: int, drop_prob: float) -> torch.Tensor:
    """Text-only TASU's simulated posterior: a token is kept where its
    uniform exceeds ``drop_prob``, each kept token's row the one-hot
    smoothed toward uniform by ``alpha``."""
    keep = [i for i, u in zip(row.gt_ids, row.u_drop.tolist()) if u > drop_prob]
    dev = row.u_drop.device
    onehot = F.one_hot(torch.as_tensor(keep, device=dev, dtype=torch.long), vocab).float()
    return (1.0 - row.alpha) * onehot + row.alpha / vocab


def project(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    y = layer_norm(x, p["norm.weight"], p["norm.bias"])
    return mm(F.silu(mm(y, p["ffn1.weight"].T) + p["ffn1.bias"]), p["ffn2.weight"].T) + p["ffn2.bias"]


def merged(w_llm: Dict, row: Row, audio: torch.Tensor, extra: Sequence[int] = ()) -> torch.Tensor:
    """Embeddings of the prompt with the audio at ``<speech>``, then
    ``extra`` tokens."""
    table = w_llm["embed_tokens.weight"]
    ids = lambda v: torch.as_tensor(list(v), device=table.device, dtype=torch.long)  # noqa: E731
    return torch.cat([table[ids(row.prompt[:row.speech_at])], audio,
                      table[ids(row.prompt[row.speech_at + 1:])], table[ids(extra)]])


def warmup_lr(lr: float, warmup: int, step: int) -> float:
    """The learning rate of update ``step`` (from 0) in the warm-up."""
    return lr * min(step, warmup) / max(warmup, 1)


@dataclass
class TrainReading:
    losses: List[float]
    grad_norms: Dict[str, float]      # of the first step's gradient, by leaf
    grad: Dict[str, torch.Tensor]     # the first step's gradient
    change_norms: Dict[str, float]    # of the parameters' change after the steps
    blank_share: float
    kept_frames: List[List[int]]      # PSD's kept frames of each row, by step


def train_steps(w: Dict[str, Dict], cfg: Dict, recipe: Dict, steps: List[List[Row]], cmvn,
                storage_dtype=torch.bfloat16) -> TrainReading:
    """The reference's run of the training steps ``steps`` (rows a step):
    the projector trains, the encoder and the LLM are frozen."""
    params = {k: v.float().clone().requires_grad_(True) for k, v in w["projector"].items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    s2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = recipe["adam_beta1"], recipe["adam_beta2"], recipe["adam_eps"]
    losses, grad_norms, grad1, kept, shares = [], {}, {}, [], []
    dither = recipe.get("dither", 0.0)
    for n, rows in enumerate(steps):
        pooled = []
        with torch.no_grad():
            for row in rows:
                if recipe.get("gt_emb"):
                    pooled.append(pseudo_posterior(row, cfg["encoder"]["vocab_size"],
                                                   recipe["drop_prob"]))
                    continue
                post = posterior(w["encoder"], cfg["encoder"], row, cmvn, dither)
                shares.append(blank_share(post))
                pooled.append(psd(post, threshold=recipe["blank_threshold"]))
        kept.append([p.shape[0] for p in pooled])
        ntok = sum(len(r.target) for r in rows)
        total = 0.0
        for row, x in zip(rows, pooled):
            seq = merged(w["llm"], row, project(params, x), row.target[:-1])
            hidden = llm.forward(w["llm"], cfg["llm"], seq)
            first = seq.shape[0] - len(row.target)          # predicts the first target token
            lg = llm.logits(w["llm"], hidden[first:])
            tgt = torch.as_tensor(row.target, device=lg.device)
            loss = F.cross_entropy(lg, tgt, reduction="sum") / ntok
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            if n == 0:
                grad_norms = {k: float(p.grad.norm()) for k, p in params.items()}
                grad1 = {k: p.grad.detach().clone() for k, p in params.items()}
            lr = warmup_lr(recipe["lr"], recipe["warmup_steps"], n)
            wd = recipe.get("weight_decay", 0.0)
            for k, p in params.items():
                g = p.grad
                m[k].mul_(b1).add_((1 - b1) * g)
                s2[k].mul_(b2).add_((1 - b2) * g * g)
                upd = (m[k] / (1 - b1 ** (n + 1))) / ((s2[k] / (1 - b2 ** (n + 1))).sqrt() + eps)
                p.copy_((p - lr * (upd + wd * p)).to(storage_dtype).float())
                p.grad = None
    change = {k: float((p.detach() - start[k]).norm()) for k, p in params.items()}
    return TrainReading(losses, grad_norms, grad1, change,
                        float(np.mean(shares)) if shares else 0.0, kept)


def served_logits(w: Dict[str, Dict], cfg: Dict, row: Row, tokens: Sequence[int], cmvn,
                  blank_threshold: float, w_llm: Optional[Dict] = None) -> torch.Tensor:
    """[len(tokens) + 1, vocab] logits of the prompt's last position and of
    each served token's: row k predicts ``tokens[k]`` (the last, what
    follows them)."""
    w_llm = w_llm or w["llm"]
    with torch.no_grad():
        post = posterior(w["encoder"], cfg["encoder"], row, cmvn)
        audio = project(w["projector"], psd(post, threshold=blank_threshold))
        seq = merged(w_llm, row, audio, tokens)
        hidden = llm.forward(w_llm, cfg["llm"], seq)
        return llm.logits(w_llm, hidden[seq.shape[0] - len(tokens) - 1:])


def gaps(logits: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
    """How far each token's logit lies below its row's best."""
    idx = torch.as_tensor(list(tokens), device=logits.device)
    rows = logits[: len(idx)]
    return rows.max(dim=-1).values - rows.gather(1, idx[:, None])[:, 0]
