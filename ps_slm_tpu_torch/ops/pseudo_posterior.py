"""CTC pseudo-posterior simulated from transcript ids (text-only TASU).

Counterpart of ``ps_slm_tpu/ops/pseudo_posterior.py``.  The JAX
``pseudo_posterior_noise`` draws its noise from ``jax.random`` inside the
function; torch's generators cannot reproduce those draws, so here the
noise is split in two:

  * :func:`noise_draws` draws every random number the noise needs, from a
    ``torch.Generator``, with the JAX function's ranges;
  * :func:`pseudo_posterior_noise` is the deterministic rest, which tests
    feed the JAX draws recomputed from the same key.

Noise model (the JAX package's defaults): per-utterance label smoothing
``(1 - alpha) * onehot + alpha / V`` with alpha ~ U(smooth_low,
smooth_high); each frame kept with probability 1 - drop_prob and the kept
frames left-compacted; then floor(n_kept * insert_prob) frames inserted,
each a duplicate of the previous frame or a blank one-hot, at uniform
slots, interleaved by a stable sort of fractional position keys.  Shapes
are fixed: [B, L + ceil(L * insert_prob), V] with ``new_lens`` validity,
and no step reads a value back to the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ps_slm_tpu_torch.ops import RowBlock, draw_rows, fp32_reciprocal


class NoiseDraws(NamedTuple):
    """The random numbers of one noise call; the insertion draws are None
    when ``ceil(L * insert_prob)`` is 0."""

    alpha: torch.Tensor                      # [B, 1, 1] smoothing weight
    u_drop: torch.Tensor                     # [B, L] in [0, 1): keep if > drop_prob
    u_pos: Optional[torch.Tensor] = None     # [B, m] in [0, 1): insertion slot
    jitter: Optional[torch.Tensor] = None    # [B, m] in [0.05, 0.45): order in a slot
    u_type: Optional[torch.Tensor] = None    # [B, m] in [0, 1): duplicate if < 0.5


def _onehot(ids: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """fp32 one-hot; ids outside [0, V) give zero rows, as ``jax.nn.one_hot``."""
    return (ids[..., None] == torch.arange(vocab_size, device=ids.device)).float()


def pseudo_posterior(
    ids: torch.Tensor, lens: torch.Tensor, vocab_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clean one-hot pseudo-posterior [B, L, V] fp32, zero past ``lens``."""
    valid = torch.arange(ids.shape[1], device=ids.device)[None] < lens[:, None]
    return _onehot(ids, vocab_size) * valid[..., None], lens


def insert_budget(length: int, insert_prob: float) -> int:
    """m = ceil(L * insert_prob): the frames the output adds for insertions."""
    return int(math.ceil(length * insert_prob))


def noise_draws(
    b: int, length: int, generator: torch.Generator, *, insert_prob: float = 0.0,
    smooth_low: float = 0.0, smooth_high: float = 0.1, block: Optional[RowBlock] = None,
) -> NoiseDraws:
    """Every draw of one :func:`pseudo_posterior_noise` call, on the
    generator's device; with ``block``, its rows of the draws for the
    global batch."""
    dev = generator.device

    def uniform(shape, lo=0.0, hi=1.0):
        u = draw_rows(lambda s: torch.rand(s, generator=generator, device=dev), shape, block)
        return u * (hi - lo) + lo

    alpha = uniform((b, 1, 1), smooth_low, smooth_high)
    u_drop = uniform((b, length))
    m = insert_budget(length, insert_prob)
    if m == 0:
        return NoiseDraws(alpha, u_drop)
    return NoiseDraws(alpha, u_drop, uniform((b, m)), uniform((b, m), 0.05, 0.45), uniform((b, m)))


def pseudo_posterior_noise(
    ids: torch.Tensor, lens: torch.Tensor, draws: NoiseDraws, *, vocab_size: int,
    drop_prob: float = 0.05, insert_prob: float = 0.0, blank_id: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CPS-noised pseudo-posterior from ``draws``: (posterior [B, L + m, V]
    fp32, left-compacted, zero past ``new_lens``; new_lens [B])."""
    b, l = ids.shape
    dev = ids.device
    alpha, u_drop = draws.alpha.to(dev), draws.u_drop.to(dev)
    pos = torch.arange(l, device=dev)[None].expand(b, l)
    valid = pos < lens[:, None]

    soft = (1.0 - alpha) * _onehot(ids, vocab_size) + alpha * fp32_reciprocal(vocab_size)
    keep = (u_drop > drop_prob) & valid
    # left compaction: kept frame i goes to (kept frames before it); the
    # dropped ones to a spare slot l that is cut off
    dest = torch.where(keep, keep.long().cumsum(1) - 1, l)
    out = soft.new_zeros(b, l + 1, vocab_size)
    out.scatter_(1, dest[..., None].expand(b, l, vocab_size), soft)
    out = out[:, :l]
    new_lens = keep.long().sum(1)

    m = insert_budget(l, insert_prob)
    if m == 0:
        return out, new_lens
    if draws.u_pos is None or draws.u_pos.shape != (b, m):
        raise ValueError(f"insert_prob {insert_prob} needs insertion draws of shape {(b, m)}")
    u_pos, jitter, u_type = (x.to(dev) for x in (draws.u_pos, draws.jitter, draws.u_type))

    n_ins = (new_lens.float() * insert_prob).floor().long()
    active = torch.arange(m, device=dev)[None] < n_ins[:, None]
    # insertion slot p in [0, n]: the frame lands between p - 1 and p; the
    # jitter keeps keys strictly between integers and orders a slot's frames
    p = (u_pos * (new_lens[:, None] + 1).float()).floor().long()
    p = torch.minimum(p, new_lens[:, None])
    ins_keys = torch.where(active, p.float() - 0.5 + jitter, math.inf)

    dup_idx = (p - 1).clamp(0, l - 1)                        # frame 0 when p = 0
    dup = out.gather(1, dup_idx[..., None].expand(b, m, vocab_size))
    blank = (torch.arange(vocab_size, device=dev) == blank_id).float()
    use_dup = (u_type < 0.5) & (new_lens[:, None] > 0)
    ins_frames = torch.where(use_dup[..., None], dup, blank) * active[..., None]

    orig_keys = torch.where(pos < new_lens[:, None], pos.float(), math.inf)
    keys = torch.cat([orig_keys, ins_keys], dim=1)               # [B, L + m]
    frames = torch.cat([out, ins_frames], dim=1)                 # [B, L + m, V]
    # stable, as jnp.argsort: the inf keys keep their index order
    order = torch.sort(keys, dim=1, stable=True).indices
    out = frames.gather(1, order[..., None].expand(b, l + m, vocab_size))
    return out, new_lens + active.long().sum(1)
