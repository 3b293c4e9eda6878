"""Routed experts: DeepSeek-V3's router and a grouped expert GEMM.

Replaces no TPU kernel: the JAX package runs no mixture of experts.  It
was added for the ``deepseek_v3`` decoder (``models/deepseek_v3.py``).

:func:`route` is the ``noaux_tc`` router with one group: the sigmoid of
fp32 logits, the top k chosen by sigmoid + ``e_score_correction_bias`` (the
bias chooses, it never weighs), the chosen sigmoid scores renormalised and
times ``routed_scaling_factor``.

:func:`experts` applies each row's chosen experts, each a SwiGLU
(``down(silu(gate(x)) * up(x))``) with its weights stacked ``gate_up``
[E, 2I, H] (gate rows first) and ``down`` [E, H, I], and sums them back to
the token rows weighted, in fp32.

* On CPU tensors, :func:`experts_ref`: a plain loop over the experts.
* On CUDA tensors (bf16), two CUDA kernels in vLLM's ``fused_moe``
  layout (``csrc/moe.cu``).  The (row, choice) pairs are sorted by expert
  on the device and padded per expert to the tile's rows, one expert id a
  tile (:func:`align`).  The grid is sized for the static upper bound,
  rows x k + E x (tile - 1), and tiles past the used ones return at once.
  So no step waits on the host, nothing's shape depends on the routing,
  and the slot pool's chunk records it in its CUDA graph.
  ``moe_grouped_gemm_gate_up`` computes silu(gate) * up from one pass over
  the rows' activations.  ``moe_grouped_gemm_down`` computes each pair's
  down projection times its weight in fp32; the k pairs of a token are
  then summed in a fixed order.

Bound.  A decode step (64 rows x 6 choices over 64 experts) reads nearly
every expert's 17.3 MB once and does 2 FLOPs a weight per row that chose
it: ~4 FLOPs a byte, far below the card's ~295 bf16 ridge, so bytes bound
it, and the design reads each (expert, tile) weight block once, with tiles
of 16 rows and 4 stages of weights in flight.  A prefill chunk (tens of
thousands of rows) is above the ridge: tiles of 64 rows on the tensor
cores (``mma.sync``).  Long inputs go through in chunks of :data:`CHUNK`
tokens, so the fp32 pair outputs stay under 1 GB.

Each call adds, on the device, the rows routed to each expert
(``moe.rows`` [2, layers, E]) and the experts it read (``moe.experts_read``
[2, layers]), index 0 for one-token steps and 1 for the rest
(:func:`ps_slm_tpu_torch.utils.profiler.tally`).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from ps_slm_tpu_torch.utils.profiler import tally

CHUNK = 32768           # tokens a grouped call at most
TILE_ROWS = (16, 64)    # csrc/moe.cu's tiles: decode steps (bytes bound), prefills

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # device, large, x, w, h, sorted_ids, tile_expert, n_pairs, top_k, tiles,
    # hidden, inter, n_exp, stream
    "ps_moe_gate_up": (_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # device, large, h, w, wts, y, sorted_ids, tile_expert, n_pairs, tiles,
    # inter, hidden, n_exp, stream
    "ps_moe_down": (_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}


def route(y: torch.Tensor, gate_weight: torch.Tensor, bias: torch.Tensor, top_k: int,
          scaling: float, norm_topk: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(chosen experts [T, k] int64, their weights [T, k] fp32) of rows y
    [T, H]."""
    scores = torch.sigmoid(F.linear(y.float(), gate_weight.float()))
    idx = torch.topk(scores + bias.float(), top_k, dim=-1).indices
    w = scores.gather(1, idx)
    if norm_topk:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * scaling


def record(idx: torch.Tensor, n_experts: int, layer: int, n_layers: int, step: bool
           ) -> torch.Tensor:
    """The rows routed to each expert [E] (int64), added to the device
    tallies of ``layer``; ``step`` marks a one-token step."""
    flat = idx.reshape(-1)
    counts = torch.zeros(n_experts, dtype=torch.long, device=idx.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    kind = 0 if step else 1
    tally("moe.rows", (2, n_layers, n_experts), idx.device)[kind, layer] += counts
    tally("moe.experts_read", (2, n_layers), idx.device)[kind, layer] += (counts > 0).sum()
    return counts


def expert_ref(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """One expert's SwiGLU over rows x, in x's dtype."""
    inter = down.shape[1]
    h = F.silu(x @ gate_up[:inter].T) * (x @ gate_up[inter:].T)
    return h @ down.T


def experts_ref(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, gate_up: torch.Tensor,
                down: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`experts`: each expert over the rows that
    chose it, the weighted sum in fp32, returned in x's dtype."""
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(gate_up.shape[0]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel():
            y = expert_ref(x[rows], gate_up[e], down[e]).float()
            out.index_add_(0, rows, w[rows, slot][:, None] * y)
    return out.to(x.dtype)


def align(idx: torch.Tensor, counts: torch.Tensor, block: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """vLLM's ``moe_align_block_size`` in tensor operations: the (row,
    choice) pairs ``t * k + j`` sorted by expert, each expert's run padded
    to a multiple of ``block`` with the sentinel ``T * k``, in a buffer of
    the static bound ``T * k + E * (block - 1)`` rounded up to ``block``
    (sorted ids), and each tile's expert, ``E`` past the used tiles."""
    flat = idx.reshape(-1)
    m, n_exp = flat.numel(), counts.numel()
    cap = -(-(m + n_exp * (block - 1)) // block) * block
    padded = (counts + block - 1) // block * block
    ends = torch.cumsum(padded, 0)
    order = torch.argsort(flat, stable=True)
    expert = flat[order]
    first = torch.cumsum(counts, 0) - counts
    dest = (ends - padded)[expert] + torch.arange(m, device=flat.device) - first[expert]
    sorted_ids = torch.full((cap,), m, dtype=torch.int32, device=flat.device)
    sorted_ids[dest] = order.to(torch.int32)
    starts = torch.arange(0, cap, block, device=flat.device)
    tile_expert = torch.searchsorted(ends, starts, right=True).to(torch.int32)
    return sorted_ids, tile_expert


def _large(tokens: int, n_experts: int, top_k: int) -> bool:
    """Whether a call takes the prefills' tiles: more pairs than 16 an expert."""
    return tokens * top_k > 16 * n_experts


def experts(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, gate_up: torch.Tensor,
            down: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Rows x [T, H] through their chosen experts ``idx`` [T, k], weighted by
    ``w`` [T, k] fp32 and summed in fp32; [T, H] in x's dtype.  ``counts``
    [E] are the rows routed to each expert (:func:`record`)."""
    if x.device.type == "cpu":
        return experts_ref(x, idx, w, gate_up, down)
    if x.dtype != torch.bfloat16 or gate_up.dtype != x.dtype or down.dtype != x.dtype:
        raise TypeError("moe.experts: the grouped kernels take bfloat16 rows and weights")
    if not (x.is_contiguous() and gate_up.is_contiguous() and down.is_contiguous()):
        raise ValueError("moe.experts: rows and weights must be contiguous")
    t = x.shape[0]
    if t > CHUNK:
        outs = []
        for a in range(0, t, CHUNK):
            part = idx[a:a + CHUNK]
            c = torch.zeros_like(counts).scatter_add_(0, part.reshape(-1),
                                                      torch.ones_like(part.reshape(-1)))
            outs.append(experts(x[a:a + CHUNK], part, w[a:a + CHUNK], gate_up, down, c))
        return torch.cat(outs)
    return _grouped(x, idx, w, gate_up, down, counts)


def _grouped(x, idx, w, gate_up, down, counts) -> torch.Tensor:
    t, hidden = x.shape
    k = idx.shape[1]
    n_exp, inter = down.shape[0], down.shape[2]
    if gate_up.shape != (n_exp, 2 * inter, hidden) or down.shape[1] != hidden:
        raise ValueError("moe.experts: gate_up must be [E, 2I, H] and down [E, H, I]")
    large = _large(t, n_exp, k)
    sorted_ids, tile_expert = align(idx, counts, TILE_ROWS[large])
    h = grouped_gate_up(x, gate_up, sorted_ids, tile_expert, k, large)
    y = grouped_down(h, down, w.reshape(-1).float().contiguous(), sorted_ids, tile_expert, large)
    experts.launches += 2
    return y.view(t, k, hidden).sum(1).to(x.dtype)


experts.launches = 0


def grouped_gate_up(x, gate_up, sorted_ids, tile_expert, top_k: int, large: bool
                    ) -> torch.Tensor:
    """``moe_grouped_gemm_gate_up``: h [pairs, I] bf16 = silu(x . gate) *
    (x . up) of each pair's expert, the pairs laid out by :func:`align`."""
    from ps_slm_tpu_torch import _build

    t, hidden = x.shape
    n_exp, inter = gate_up.shape[0], gate_up.shape[1] // 2
    h = torch.empty((t * top_k, inter), dtype=x.dtype, device=x.device)
    lib = _build.load("moe", _SIGNATURES)
    err = lib.ps_moe_gate_up(x.device.index, int(large), x.data_ptr(), gate_up.data_ptr(),
                             h.data_ptr(), sorted_ids.data_ptr(), tile_expert.data_ptr(),
                             t * top_k, top_k, tile_expert.numel(), hidden, inter, n_exp,
                             _build.stream_ptr(x))
    _build.check(lib, err, "moe_grouped_gemm_gate_up")
    return h


def grouped_down(h, down, wts, sorted_ids, tile_expert, large: bool) -> torch.Tensor:
    """``moe_grouped_gemm_down``: y [pairs, H] fp32 = wts[pair] * (h . down)
    of each pair's expert."""
    from ps_slm_tpu_torch import _build

    pairs, inter = h.shape
    n_exp, hidden = down.shape[0], down.shape[1]
    y = torch.empty((pairs, hidden), dtype=torch.float32, device=h.device)
    lib = _build.load("moe", _SIGNATURES)
    err = lib.ps_moe_down(h.device.index, int(large), h.data_ptr(), down.data_ptr(),
                          wts.data_ptr(), y.data_ptr(), sorted_ids.data_ptr(),
                          tile_expert.data_ptr(), pairs, tile_expert.numel(), inter, hidden,
                          n_exp, _build.stream_ptr(h))
    _build.check(lib, err, "moe_grouped_gemm_down")
    return y
