"""Tensor parallelism written out: the shards a rank holds and the
collectives between them.

Counterpart of what the JAX package's GSPMD derives from the ``tensor``
axis of its sharding rules (``ps_slm_tpu/parallel/mesh.py``).  Under a
``tensor`` axis of size T each rank holds plain tensors, its own block of
each sharded weight, and the modules call the collectives themselves
(Megatron's layout), with plain ``torch.distributed`` calls that gloo
takes on CUDA tensors (``all_reduce`` and ``all_gather_into_tensor``):

* :func:`copy_in` before a column-parallel projection: the identity, and
  in the backward the sum of the ranks' partial input gradients;
* :func:`reduce_out` after a row-parallel one: the sum of the ranks'
  partial outputs, and the identity in the backward;
* :func:`vocab_embed`: the lookup of a table sharded on its vocabulary
  rows (each rank looks up the ids in its range, zeros the others, and
  the sum gives every row);
* :func:`vocab_parallel_nll`: the cross-entropy of logits sharded on the
  vocabulary (the global max, the sum of exponentials and the picked
  logit each from the ranks' parts), with its own backward;
* :func:`qkv_rows`: the rows of a fused ``qkv`` projection that hold a
  rank's heads (q, k and v of heads ``[r h/T, (r+1) h/T)``).

:class:`Shards` is a rank's view of the group; a test may give another
one whose collectives combine threads of one process.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F


class Shards:
    """One rank of a tensor-parallel group: its index ``rank`` of
    ``size`` and the sum and the gather over the group (``group``, a
    ``torch.distributed`` process group)."""

    def __init__(self, rank: int, size: int, group=None):
        self.rank, self.size, self.group = rank, size, group

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group, in place."""
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order: [size, *t.shape]."""
        out = t.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t.contiguous(), group=self.group)
        return out.view((self.size,) + tuple(t.shape))

    def block(self, n: int) -> slice:
        """This rank's block of ``n`` (a whole multiple of ``size``) rows."""
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shards):
        ctx.shards = shards
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.shards.all_reduce(g.contiguous().clone()), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shards):
        return shards.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(x: torch.Tensor, shards: Shards) -> torch.Tensor:
    """``x`` (the same on every rank) as the input of this rank's part; its
    gradient is the sum of the parts' gradients."""
    return _CopyIn.apply(x, shards)


def reduce_out(x: torch.Tensor, shards: Shards) -> torch.Tensor:
    """The sum of the ranks' partial ``x``; each part's gradient is the
    sum's."""
    return _ReduceOut.apply(x, shards)


def parallel_mlp(x: torch.Tensor, first: torch.nn.Linear, act, second: torch.nn.Linear,
                 shards: Shards) -> torch.Tensor:
    """``second(act(first(x)))`` with ``first`` holding this rank's block
    of output rows (column-parallel) and ``second`` the matching input
    columns (row-parallel): the partial outputs summed, then
    ``second``'s whole bias."""
    y = act(first(copy_in(x, shards)))
    out = reduce_out(F.linear(y, second.weight), shards)
    return out if second.bias is None else out + second.bias


@torch.no_grad()
def gather_rows(t: torch.Tensor, shards: Shards) -> torch.Tensor:
    """The whole of a tensor sharded on its rows, on every rank (no
    gradient)."""
    return shards.all_gather(t).reshape((-1,) + tuple(t.shape[1:]))


@torch.no_grad()
def gather_last(t: torch.Tensor, shards: Shards) -> torch.Tensor:
    """The whole of a tensor sharded on its last dimension (no gradient)."""
    parts = shards.all_gather(t)
    return torch.cat(list(parts.unbind(0)), dim=-1)


def vocab_embed(table: torch.Tensor, ids: torch.Tensor, shards: Shards) -> torch.Tensor:
    """``whole_table[ids]`` from this rank's rows ``table`` (the block
    ``[r V/T, (r+1) V/T)``): the ids in the block looked up, the others
    zero, summed over the ranks.  Exact: one rank adds each row."""
    n = table.shape[0]
    local = ids - shards.rank * n
    inside = (local >= 0) & (local < n)
    rows = F.embedding(torch.where(inside, local, 0), table)
    return reduce_out(torch.where(inside[..., None], rows, torch.zeros_like(rows)), shards)


def vocab_mix(probs: torch.Tensor, table: torch.Tensor, v_real: int,
              shards: Shards) -> torch.Tensor:
    """``probs @ whole_table[:v_real]`` from this rank's rows: its columns
    of ``probs`` (the same on every rank) times its rows below
    ``v_real``, summed over the ranks."""
    n = table.shape[0]
    lo = min(shards.rank * n, v_real)
    hi = min(lo + n, v_real)
    probs = copy_in(probs, shards)
    return reduce_out(probs[..., lo:hi] @ table[:hi - lo], shards)


class _VocabNLL(torch.autograd.Function):
    """The NLL of each row of fp32 logits sharded on the vocabulary."""

    @staticmethod
    def forward(ctx, logits, y, shards):
        n = logits.shape[-1]
        lo = shards.rank * n
        gmax = shards.all_gather(logits.max(dim=-1).values).max(dim=0).values
        sumexp = shards.all_reduce(torch.exp(logits - gmax[:, None]).sum(dim=-1))
        lse = gmax + torch.log(sumexp)
        local = y - lo
        inside = (local >= 0) & (local < n)
        safe = torch.where(inside, local, 0)
        picked = torch.where(inside, logits.gather(-1, safe[:, None])[:, 0], 0.0)
        picked = shards.all_reduce(picked)
        ctx.save_for_backward(logits, lse, safe, inside)
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        logits, lse, safe, inside = ctx.saved_tensors
        grad = torch.exp(logits - lse[:, None])
        grad.scatter_add_(-1, safe[:, None], -inside.to(grad.dtype)[:, None])
        return grad * g[:, None], None, None


def vocab_parallel_nll(logits: torch.Tensor, y: torch.Tensor, shards: Shards
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(NLL [N], global argmax [N]) of the rows of ``logits`` [N, V/T]
    (fp32, this rank's vocabulary block) against labels ``y`` [N] (global
    ids, each in range).  The NLL is lse - picked with the global max and
    the sum of exponentials taken over the ranks; its gradient in the
    local logits is softmax_local - onehot_local.  The argmax is the
    global first maximum (the largest value, then the lowest id), as
    ``argmax`` over the whole row."""
    nll = _VocabNLL.apply(logits, y, shards)
    with torch.no_grad():
        n = logits.shape[-1]
        idx = logits.argmax(dim=-1)
        vals = logits.gather(-1, idx[:, None])[:, 0]
        all_vals = shards.all_gather(vals)                         # [T, N]
        all_idx = shards.all_gather(idx + shards.rank * n)
        first = (all_vals == all_vals.max(dim=0).values).to(torch.int8).argmax(dim=0)
        arg = all_idx.gather(0, first[None])[0]
    return nll, arg


def qkv_rows(d: int, size: int, rank: int, device=None) -> torch.Tensor:
    """The rows of a fused [3 d, in] ``qkv`` weight (q, k, v stacked) that
    hold rank ``rank``'s heads: its block of q's d rows, then of k's, then
    of v's."""
    k = d // size
    block = torch.arange(rank * k, (rank + 1) * k, device=device)
    return torch.cat([block, block + d, block + 2 * d])


def from_shards(parts, dim: int, by_heads: bool = False) -> torch.Tensor:
    """The whole tensor from the ranks' blocks ``parts`` (rank order) on
    ``dim``; ``by_heads``: blocks in :func:`qkv_rows`' layout, put back in
    q, k, v order."""
    if not by_heads:
        return torch.cat(list(parts), dim=dim)
    thirds = [p.chunk(3, dim=dim) for p in parts]
    return torch.cat([t[j] for j in range(3) for t in thirds], dim=dim)


def check_heads(what: str, heads: int, size: int, kv_heads: Optional[int] = None) -> None:
    """Raise unless every rank of ``size`` gets whole heads."""
    for n in (heads, kv_heads):
        if n is not None and n % size:
            raise ValueError(f"{what}: {n} heads do not split over tensor={size}")
