"""Causal cross-entropy over a large vocabulary: gathered and chunked forms.

Counterpart of ``ps_slm_tpu/ops/ce_loss.py``.  Both take the pre-shift
hidden states [B, T, H], the unembedding weight [V, H] (``nn.Linear``'s
layout: the tied embedding table or ``lm_head.weight``) and the pre-shift
labels [B, T] (``ignore_id`` = no label); hidden[:, t] predicts
labels[:, t + 1].  Logits are fp32 after a matmul in the weight's dtype.
Both return ``(loss, acc, ntokens)``: the mean NLL and the argmax accuracy
over the valid positions, and their count.  With ``reduce`` (a function
that sums a count over the processes that split the batch), the count is
the global batch's and the sums are divided by it: each process's loss is
then its share of the global mean, and the shares sum to it.  With
``vocab`` (a ``parallel.tensor.Shards``) the weight is this rank's block of
the vocabulary's rows and the CE is vocabulary-parallel
(``parallel.tensor.vocab_parallel_nll``): the hidden states' gradient is
summed over the ranks, and every rank gets the whole rows' loss and
accuracy.

* :func:`gathered_ce_loss`: in a merged audio+text batch only the text
  targets carry labels, so each row's valid positions are moved to the
  front (a stable argsort on the validity mask) and only ``max_valid`` rows
  per batch row are unembedded.
* :func:`chunked_ce_loss`: the logits of one chunk of positions at a time,
  each chunk under ``torch.utils.checkpoint`` so the backward recomputes
  them chunk by chunk (the JAX ``jax.checkpoint`` inside a scan).
* :func:`full_ce_loss`: the whole [B, T-1, V] fp32 logits at once.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ps_slm_tpu_torch.parallel.tensor import copy_in, vocab_parallel_nll


def _ce_sums(
    x: torch.Tensor, weight: torch.Tensor, y: torch.Tensor, valid: torch.Tensor, vocab=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed NLL, argmax-correct count) over the valid positions of x;
    vocabulary-parallel with ``vocab``."""
    safe = torch.where(valid, y, 0)
    if vocab is not None:
        x = copy_in(x, vocab)
    logits = F.linear(x.to(weight.dtype), weight).float()
    if vocab is not None:
        nll, arg = vocab_parallel_nll(logits.reshape(-1, logits.shape[-1]), safe.reshape(-1),
                                      vocab)
        nll, arg = nll.view(safe.shape), arg.view(safe.shape)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        nll = lse - logits.gather(-1, safe[..., None])[..., 0]
        arg = logits.argmax(dim=-1)
    nll = torch.where(valid, nll, 0.0)
    correct = ((arg == safe) & valid).sum()
    return nll.sum(), correct


def _mean(
    nll: torch.Tensor, correct: torch.Tensor, valid: torch.Tensor, reduce=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean NLL, accuracy, count) from the sums over the valid positions;
    the count summed by ``reduce`` when given."""
    ntok = valid.sum()
    if reduce is not None:
        ntok = reduce(ntok)
    denom = ntok.clamp(min=1)
    return nll / denom, correct / denom, ntok


def gathered_ce_loss(
    hidden: torch.Tensor, weight: torch.Tensor, labels: torch.Tensor,
    *, max_valid: int, ignore_id: int = -100, reduce=None, vocab=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CE over at most ``max_valid`` valid positions per row (after the
    shift); positions beyond that bound are dropped silently, so callers
    size it from the pre-merge text length, as the JAX forward does."""
    b, t, h = hidden.shape
    x = hidden[:, :-1]
    y = labels[:, 1:].long()
    valid = y != ignore_id
    m = min(max_valid, t - 1)
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)[:, :m]
    xs = x.gather(1, order[..., None].expand(b, m, h))
    ys = y.gather(1, order)
    vs = valid.gather(1, order)
    return _mean(*_ce_sums(xs, weight, ys, vs, vocab), vs, reduce)


def chunked_ce_loss(
    hidden: torch.Tensor, weight: torch.Tensor, labels: torch.Tensor,
    *, ignore_id: int = -100, chunk: int = 128, reduce=None, vocab=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CE over every position, ``chunk`` positions' logits at a time."""
    x = hidden[:, :-1]
    y = labels[:, 1:].long()
    valid = y != ignore_id
    nll = hidden.new_zeros((), dtype=torch.float32)
    correct = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for c0 in range(0, x.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        s, c = checkpoint(
            _ce_sums, x[:, sl], weight, y[:, sl], valid[:, sl], vocab, use_reentrant=False
        )
        nll = nll + s
        correct = correct + c
    return _mean(nll, correct, valid, reduce)


def full_ce_loss(
    hidden: torch.Tensor, weight: torch.Tensor, labels: torch.Tensor,
    *, ignore_id: int = -100, reduce=None, vocab=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CE over every position, all logits at once."""
    y = labels[:, 1:].long()
    valid = y != ignore_id
    return _mean(*_ce_sums(hidden[:, :-1], weight, y, valid, vocab), valid, reduce)
