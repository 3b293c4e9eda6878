"""SenseVoiceSmall as rich-label ASR, float32, and the judge of an ASR
output against it.

The reference's own output of an utterance: log-softmax of the CTC
logits over the query frames and the speech frames (the emotion-unknown
label banned when asked), the greedy path (each frame's best label,
repeats collapsed, blanks dropped), and the speech frames' Viterbi
alignment to the tokens after the four rich ones, in which a frame whose
best label is blank has its blank log-probability set to 0.

The judge reads an output (tokens and the frame run of each aligned
token) against the reference's log-probabilities:

* ``greedy_gap``: how far the best CTC path that collapses to the output's
  tokens lies below the best path of all, in nats;
* ``align_gap``: how far the output's alignment path lies below the best
  alignment of the same tokens; an alignment that is no CTC path of them
  reads infinite.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import encoder as enc
from portbench.reference import frontend

NEG = -1e30


def log_probs(w: Dict, cfg: Dict, samples: torch.Tensor, cmvn, query_ids: Sequence[int],
              banned: Optional[int]) -> torch.Tensor:
    feats = frontend.features(samples, cmvn)
    _, logits = enc.encode(w, cfg, feats, query_ids)
    lp = torch.log_softmax(logits, dim=-1)
    if banned is not None:
        lp[:, banned] = float("-inf")
    return lp


def greedy(lp: np.ndarray, blank: int = 0) -> List[int]:
    ids = lp.argmax(axis=1)
    out, prev = [], None
    for i in ids:
        if i != prev and i != blank:
            out.append(int(i))
        prev = i
    return out


def _ctc_viterbi(lp: np.ndarray, tokens: Sequence[int], blank: int = 0
                 ) -> Tuple[float, List[int]]:
    """Best score of a CTC path over ``lp`` [T, V] collapsing to ``tokens``,
    and that path's label a frame."""
    t_len = lp.shape[0]
    ext = [blank]
    for tok in tokens:
        ext += [tok, blank]
    s = len(ext)
    if t_len == 0 or len(tokens) > t_len:
        return NEG, []
    emit = lp[:, ext]                                           # [T, S]
    skip = np.zeros(s, bool)
    for j in range(2, s):
        skip[j] = ext[j] != blank and ext[j] != ext[j - 2]
    alpha = np.full(s, NEG)
    alpha[0] = emit[0, 0]
    if s > 1:
        alpha[1] = emit[0, 1]
    back = np.zeros((t_len, s), np.int8)
    for t in range(1, t_len):
        step, jump = np.full(s, NEG), np.full(s, NEG)
        step[1:], jump[2:] = alpha[:-1], alpha[:-2]
        cand = np.stack([alpha, step, np.where(skip, jump, NEG)])
        back[t] = cand.argmax(axis=0)
        alpha = cand.max(axis=0) + emit[t]
    ends = [s - 1, s - 2] if s > 1 else [0]
    end = max(ends, key=lambda j: alpha[j])
    score = float(alpha[end])
    path, j = [0] * t_len, end
    for t in range(t_len - 1, -1, -1):
        path[t] = ext[j]
        j -= int(back[t, j])
    return score, path


def speech_logp(lp: np.ndarray, blank: int = 0, queries: int = 4) -> np.ndarray:
    """The speech frames' log-probabilities as the alignment reads them."""
    sp = lp[queries:].copy()
    best_blank = sp.argmax(axis=1) == blank
    sp[best_blank, blank] = 0.0
    return sp


def runs(path: Sequence[int], blank: int = 0) -> List[Tuple[int, int, int]]:
    """(token, first frame, end frame) of each non-blank run."""
    out, t = [], 0
    while t < len(path):
        if path[t] == blank:
            t += 1
            continue
        u = t
        while u < len(path) and path[u] == path[t]:
            u += 1
        out.append((int(path[t]), t, u))
        t = u
    return out


def output(lp: np.ndarray, blank: int = 0) -> Tuple[List[int], List[Tuple[int, int, int]]]:
    """The reference's own (tokens, runs of the aligned speech tokens)."""
    tokens = greedy(lp, blank)
    _, path = _ctc_viterbi(speech_logp(lp, blank), tokens[4:], blank)
    return tokens, runs(path, blank)


def judge(lp: np.ndarray, tokens: Sequence[int], aligned: Sequence[Tuple[int, int, int]],
          blank: int = 0) -> Dict[str, float]:
    """``greedy_gap`` and ``align_gap`` of an output (module docstring)."""
    best, _ = float(lp.max(axis=1).sum()), None
    fit, _ = _ctc_viterbi(lp, tokens, blank)
    sp = speech_logp(lp, blank)
    target = list(tokens[4:])
    opt, _ = _ctc_viterbi(sp, target, blank)
    path = [blank] * sp.shape[0]
    ok = [tok for tok, _, _ in aligned] == target
    prev_end, prev_tok = 0, None
    for tok, a, b in aligned:
        if not (prev_end <= a < b <= sp.shape[0]) or (tok == prev_tok and a == prev_end):
            ok = False
            break
        path[a:b] = [tok] * (b - a)
        prev_end, prev_tok = b, tok
    score = float(sp[np.arange(sp.shape[0]), path].sum()) if ok else NEG
    return {"greedy_gap": best - fit, "align_gap": opt - score if ok else float("inf")}
