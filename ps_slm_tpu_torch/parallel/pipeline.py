"""GPipe pipeline parallelism over the LLM's layer stack.

Counterpart of ``ps_slm_tpu/parallel/pipeline.py``.  The processes along
the mesh's ``pipe`` axis are the P stages; stage s runs the contiguous
layers ``[s L/P, (s + 1) L/P)``.  M microbatches flow through in
``M + P - 1`` steps, in lockstep on every stage as the JAX ``shard_map``
schedule runs: at step t stage s runs microbatch ``t - s`` and passes its
output to stage s + 1.  The positions and the attention mask need no
passing: every stage holds the whole (pipe-replicated) batch and reads
the microbatch it runs.  Stage P-1's outputs reach every stage (the JAX
``psum`` over ``pipe``).

The backward is the reverse schedule, written out in
:class:`_Pipeline` (an autograd function): each stage keeps the graph of
each microbatch it ran (each layer under ``torch.utils.checkpoint`` with
``remat``, as ``run_block`` does), takes the gradient of its output from
the next stage (or, at P-1, from the loss), and passes the gradient of its
input to the previous one; stage 0's input gradient then reaches every
stage, so what lies before the stack (the projector, the embeddings)
computes the same gradients on every stage.  A stage holds only its own
layers (``parallel/mesh.py`` frees the rest), and their gradients stay on
it.  Activations and their gradients move between neighbours by
point-to-point sends (``batch_isend_irecv``); gloo sends only host
tensors, so under gloo a CUDA tensor goes through the host.

A stage composes with ``fsdp`` and ``tensor`` within it: the rank at
coordinate (d, f, t) of one stage sends to the same coordinate of the
next (the ``pipe`` group's ranks).  Under ``tensor`` the stage's blocks
call their collectives over the stage's tensor group; under ``fsdp`` each
of its layers is an FSDP2 unit that gathers its shards for each
microbatch's forward and backward, and holds the reduce-scatter of its
gradients until the last microbatch's backward
(``set_requires_gradient_sync``), so the sum over the microbatches is
taken once, as the unpipelined step's.

Bubble fraction = (P-1)/(M+P-1).  LoRA dropout masks are drawn per layer
and microbatch, in that order, on every stage (so the generators stay
together); at M=1 they are the unpipelined step's masks.  Decode (KV
cache) paths do not use this module.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ps_slm_tpu_torch.models.layers import run_block
from ps_slm_tpu_torch.models.lora import lora_dropout_masks


def microbatch_count(batch: int, n_micro: int, n_stages: int) -> int:
    """Effective microbatch count: the largest divisor of ``batch`` that is
    <= the requested count (default 2*stages).  Always >= 1."""
    want = n_micro if n_micro > 0 else 2 * n_stages
    want = max(1, min(want, batch))
    for m in range(want, 0, -1):
        if batch % m == 0:
            return m
    return 1


class _Schedule:
    """One pipelined run of the stack: this stage's layers, the
    microbatched positions, mask and dropout masks, and the transfers
    between stages."""

    def __init__(self, llm, positions, mask, keep, rate):
        ctx = llm.mesh
        self.llm, self.keep, self.rate = llm, keep, rate
        self.p, self.s = ctx.shape["pipe"], ctx.stage
        self.group = ctx.groups.get("pipe")
        per = len(llm.layers) // self.p
        self.layers = range(self.s * per, (self.s + 1) * per)
        self.positions, self.mask = positions, mask
        self.ranks = [dist.get_global_rank(self.group, k) for k in range(self.p)] \
            if self.group is not None else [0]
        self.via_host = self.group is not None and dist.get_backend(self.group) == "gloo"

    def gradient_sync(self, on: bool) -> None:
        """Whether this stage's FSDP2 layers reduce-scatter their gradients
        after the next backward (off: they accumulate them whole)."""
        from torch.distributed.fsdp import FSDPModule

        for i in self.layers:
            layer = self.llm.layers[i]
            if isinstance(layer, FSDPModule):
                layer.set_requires_gradient_sync(on, recurse=False)

    def stage(self, x: torch.Tensor, m: int) -> torch.Tensor:
        remat = self.llm.remat and torch.is_grad_enabled()
        for i in self.layers:
            keep = None if self.keep is None else self.keep[i][m]
            x = run_block(self.llm.layers[i], remat, x, self.positions[m],
                          None if self.mask is None else self.mask[m], None, None, keep,
                          self.rate)
        return x

    def exchange(self, t: Optional[torch.Tensor], send_to: Optional[int], like: torch.Tensor,
                 recv_from: Optional[int]) -> Optional[torch.Tensor]:
        """Send ``t`` to stage ``send_to`` and receive a tensor shaped as
        ``like`` from stage ``recv_from`` (None: no such transfer), posted
        together; returns what was received, on ``like``'s device."""
        host = self.via_host and like.is_cuda
        ops, out = [], None
        if send_to is not None:
            buf = t.detach().contiguous()
            ops.append(dist.P2POp(dist.isend, buf.cpu() if host else buf, self.ranks[send_to],
                                  self.group))
        if recv_from is not None:
            out = torch.empty(like.shape, dtype=like.dtype, device="cpu" if host else like.device)
            ops.append(dist.P2POp(dist.irecv, out, self.ranks[recv_from], self.group))
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()
        return None if out is None else out.to(like.device)

    def from_stage(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Stage ``src``'s ``t`` on every stage (a broadcast)."""
        if self.p > 1:
            dist.broadcast(t, self.ranks[src], group=self.group)
        return t


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, anchor, run: _Schedule, record: bool):
        m, p, s = xs.shape[0], run.p, run.s
        outs = torch.zeros_like(xs)
        saved: Dict[int, tuple] = {}
        act = None
        for t in range(m + p - 1):
            mi = t - s                       # the microbatch this stage runs at step t
            y = None
            if 0 <= mi < m:
                x_in = (xs[mi] if s == 0 else act).detach().requires_grad_(record)
                with torch.set_grad_enabled(record):
                    y = run.stage(x_in, mi)
                if record:
                    saved[mi] = (x_in, y)
                y = y.detach()
                if s == p - 1:
                    outs[mi] = y
            act = run.exchange(y, s + 1 if s < p - 1 and 0 <= mi < m else None, xs[0],
                               s - 1 if s > 0 and 0 <= t - s + 1 < m else None)
        ctx.run, ctx.saved = run, saved
        return run.from_stage(outs, p - 1)

    @staticmethod
    def backward(ctx, g_outs):
        run, saved = ctx.run, ctx.saved
        m, p, s = g_outs.shape[0], run.p, run.s
        g_xs = torch.zeros_like(g_outs)
        g_act = None
        for t in reversed(range(m + p - 1)):
            mi = t - s
            g_in = None
            if 0 <= mi < m:
                run.gradient_sync(mi == 0)       # microbatch 0's backward runs last
                x_in, y = saved.pop(mi)
                g_y = g_outs[mi] if s == p - 1 else g_act
                if y.requires_grad:
                    torch.autograd.backward(y, g_y)
                g_in = x_in.grad if x_in.grad is not None else torch.zeros_like(x_in)
                if s == 0:
                    g_xs[mi] = g_in
            g_act = run.exchange(g_in, s - 1 if s > 0 and 0 <= mi < m else None, g_outs[0],
                                 s + 1 if s < p - 1 and 0 <= t - s - 1 < m else None)
        return run.from_stage(g_xs, 0), None, None, None


def pipeline_apply(
    llm, x: torch.Tensor, positions: torch.Tensor, mask: Optional[torch.Tensor], *,
    generator: Optional[torch.Generator] = None,
    lora_masks: Optional[List[Dict[str, torch.Tensor]]] = None, rate: float = 0.0,
) -> torch.Tensor:
    """Run ``x`` [B, S, H] through ``llm``'s whole layer stack, pipelined
    over the mesh's ``pipe`` axis (``llm.mesh``) in ``llm.pp_microbatches``
    microbatches (:func:`microbatch_count`).  ``positions`` [B, S],
    ``mask`` [B, S] or None.  LoRA dropout (``rate`` > 0): each layer's
    masks from ``lora_masks`` (cut per microbatch) or drawn from
    ``generator``.  Returns the stack's output (before the final norm) on
    every stage."""
    ctx = llm.mesh
    p = ctx.shape["pipe"]
    n = len(llm.layers)
    if n % p:
        raise ValueError(f"pipeline: {n} layers not divisible by pipe={p}")
    b = x.shape[0]
    m = microbatch_count(b, llm.pp_microbatches, p)
    mb = b // m

    def micro(t):
        return None if t is None else t.reshape((m, mb) + tuple(t.shape[1:]))

    keep = None
    if rate > 0.0 and lora_masks is not None:
        keep = [[{k: v[i * mb:(i + 1) * mb] for k, v in lora_masks[j].items()}
                 for i in range(m)] for j in range(n)]
    elif rate > 0.0 and generator is not None:
        keep = [[lora_dropout_masks(layer, (mb,) + tuple(x.shape[1:]), rate, generator,
                                    x.device, ctx.row_block) for _ in range(m)]
                for layer in llm.layers]
    run = _Schedule(llm, micro(positions), micro(mask), keep, rate)
    record = torch.is_grad_enabled() and (
        x.requires_grad or any(q.requires_grad for q in llm.layers.parameters()))
    anchor = torch.zeros((), device=x.device, requires_grad=record)
    out = _Pipeline.apply(micro(x), anchor, run, record)
    return out.reshape(x.shape)
