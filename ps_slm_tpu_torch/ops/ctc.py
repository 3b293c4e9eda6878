"""CTC primitives: loss, Viterbi forced alignment, greedy decode.

Counterpart of ``ps_slm_tpu/ops/ctc.py``, in plain PyTorch:

  * :func:`ctc_loss`: the mean over the batch of each row's negative log
    likelihood, logits in fp32.  The JAX function calls ``optax.ctc_loss``;
    this is its alpha recursion, vectorised over the batch and the lattice
    states with a loop over the frames, with optax's ``log_epsilon`` of
    -1e5 for impossible transitions, so a row whose labels cannot fit its
    frames stays finite (``F.ctc_loss`` gives ``inf`` there, and its CUDA
    backward is not deterministic).  The gradient comes from autograd, in
    a fixed order on the card too.
  * :func:`ctc_forced_align`: Viterbi over the blank-interleaved lattice,
    then the backtrace; ties go to ``[stay, prev1, prev2]`` in that order
    (``torch.argmax`` returns the first maximum, as ``jnp.argmax``); frames
    at or past a row's length are blank.  A loop of tensor ops over the
    frames, with no host sync inside.
  * :func:`ctc_greedy_decode`: argmax, collapse repeats, drop blanks,
    left-compacted at fixed shapes (the JAX ``mode="drop"`` scatter is a
    scatter into a ``T + 1``-wide buffer, then sliced).
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30
LOG_EPSILON = -1e5   # optax.ctc_loss's log(+0)


def _ctc_nll(
    logits: torch.Tensor,      # [B, T, V]
    logit_lens: torch.Tensor,  # [B]
    labels: torch.Tensor,      # [B, L]
    label_lens: torch.Tensor,  # [B]
    blank_id: int,
) -> torch.Tensor:
    """Per-row CTC negative log likelihood, optax's recursion step for step,
    in fp32 (float64 logits stay float64)."""
    b, t, v = logits.shape
    n = labels.shape[1]
    dev = logits.device
    dt = torch.promote_types(logits.dtype, torch.float32)
    logprobs = torch.log_softmax(logits.to(dt), dim=-1)
    labels = labels.to(dev).long()
    label_lens = label_lens.to(dev).long()
    pad = torch.arange(t, device=dev)[None, :] >= logit_lens.to(dev)[:, None]   # [B, T]

    # repeat[b, n]: label n equals label n + 1 (the last column 0)
    repeat = torch.zeros(b, n, device=dev, dtype=dt)
    if n > 1:
        repeat[:, :-1] = (labels[:, :-1] == labels[:, 1:]).to(dt)
    # emission log-probs of each label, by a one-hot product as optax takes
    # them (0 off the vocabulary); its backward is a matmul, where a
    # gather's would scatter-add repeated labels with atomics, in no fixed
    # order on the card
    in_vocab = (labels >= 0) & (labels < v)
    one_hot = torch.nn.functional.one_hot(labels.clamp(0, v - 1), v).to(dt)
    one_hot = one_hot * in_vocab[..., None].to(dt)
    emit_all = torch.einsum("btk,bnk->btn", logprobs, one_hot)         # [B, T, N]
    phi_all = logprobs[:, :, blank_id]                                 # [B, T]

    phi = torch.full((b, n + 1), LOG_EPSILON, device=dev, dtype=dt)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), LOG_EPSILON, device=dev, dtype=dt)
    eps_repeat = LOG_EPSILON * repeat
    eps_not_repeat = LOG_EPSILON * (1.0 - repeat)

    def add_phi(p, score):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], score)], dim=1)

    for i in range(t):
        prev_phi_orig = phi
        prev_phi = add_phi(phi, emit + eps_repeat)
        lp_emit, lp_phi = emit_all[:, i], phi_all[:, i:i + 1]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit, emit + lp_emit)
        next_phi = add_phi(prev_phi + lp_phi, emit + lp_phi + eps_not_repeat)
        p = pad[:, i:i + 1]
        emit = torch.where(p, emit, next_emit)
        phi = torch.where(p, prev_phi_orig, next_phi)
    phi_last = add_phi(phi, emit)
    return -phi_last.gather(1, label_lens[:, None])[:, 0]


def ctc_loss(
    logits: torch.Tensor,       # [B, T, V]
    logit_lens: torch.Tensor,   # [B]
    labels: torch.Tensor,       # [B, L]
    label_lens: torch.Tensor,   # [B]
    blank_id: int = 0,
) -> torch.Tensor:
    """Mean over the batch of the per-row CTC loss (fp32 scalar)."""
    return _ctc_nll(logits, logit_lens, labels, label_lens, blank_id).mean()


def ctc_forced_align(
    log_probs: torch.Tensor,    # [B, T, V]
    targets: torch.Tensor,      # [B, L]
    input_lens: torch.Tensor,   # [B]
    target_lens: torch.Tensor,  # [B]
    blank: int = 0,
) -> torch.Tensor:
    """Batched Viterbi alignment: [B, T] lattice labels (blank or the
    target token each frame); frames >= a row's length are blank."""
    b, t, _ = log_probs.shape
    l = targets.shape[1]
    s = 2 * l + 1
    dev = log_probs.device
    out_dtype = targets.dtype
    targets = targets.to(dev).long()
    input_lens = input_lens.to(dev).long()
    target_lens = target_lens.to(dev).long()
    ext = torch.full((b, s), blank, device=dev, dtype=torch.long)
    ext[:, 1::2] = targets
    pos = torch.arange(s, device=dev)
    ext_prev2 = torch.cat([torch.full((b, 2), -1, device=dev, dtype=torch.long), ext[:, :-2]], 1)
    skip_ok = ((pos >= 2) & (pos % 2 == 1))[None, :] & (ext != ext_prev2)

    emit = log_probs.float().gather(2, ext[:, None, :].expand(b, t, s))   # [B, T, S]
    neg = torch.full((b, 1), NEG_INF, device=dev)
    alpha = torch.full((b, s), NEG_INF, device=dev)
    alpha[:, 0] = emit[:, 0, 0]
    if l > 0:
        alpha[:, 1] = emit[:, 0, 1]
    alphas = [alpha]
    backs = []
    for i in range(1, t):
        prev1 = torch.cat([neg, alpha[:, :-1]], 1)
        prev2 = torch.where(skip_ok, torch.cat([neg, neg, alpha[:, :-2]], 1), NEG_INF)
        stacked = torch.stack([alpha, prev1, prev2])
        best, back = stacked.max(dim=0), stacked.argmax(dim=0)
        alpha = best.values + emit[:, i]
        alphas.append(alpha)
        backs.append(back)
    alpha_all = torch.stack(alphas, 1)                                   # [B, T, S]

    rows = torch.arange(b, device=dev)
    final = alpha_all[rows, (input_lens - 1).clamp(min=0)]              # [B, S]
    end1, end2 = 2 * target_lens - 1, 2 * target_lens
    last = torch.where(final[rows, end1.clamp(min=0)] >= final[rows, end2], end1, end2)
    state = last.clamp(min=0)
    states = [state]
    for i in range(t - 1, 0, -1):
        jump = backs[i - 1][rows, state]
        state = torch.where(i <= input_lens - 1, state - jump, state)
        states.append(state)
    states = torch.stack(states[::-1], 1)                                # [B, T]
    labels = ext.gather(1, states)
    valid = torch.arange(t, device=dev)[None, :] < input_lens[:, None]
    return torch.where(valid, labels, blank).to(out_dtype)


def ctc_greedy_decode(
    log_probs: torch.Tensor,   # [B, T, V]
    lens: torch.Tensor,        # [B]
    blank: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Argmax -> collapse repeats -> drop blanks, left-compacted.
    Returns (ids [B, T] padded with blank, out_lens [B] int32)."""
    b, t, _ = log_probs.shape
    dev = log_probs.device
    ids = log_probs.argmax(dim=-1)                                       # [B, T]
    valid = torch.arange(t, device=dev)[None, :] < lens.to(dev)[:, None]
    prev = torch.cat([ids[:, :1] - 1, ids[:, :-1]], dim=1)
    keep = (ids != prev) & (ids != blank) & valid
    dest = torch.where(keep, torch.cumsum(keep.long(), dim=1) - 1, t)
    out = torch.full((b, t + 1), blank, device=dev, dtype=ids.dtype)
    out.scatter_(1, dest, ids)    # dropped frames all land in column t
    return out[:, :t], keep.sum(dim=1).to(torch.int32)
