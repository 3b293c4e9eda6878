"""Encoder -> LLM projectors.

Counterpart of ``ps_slm_tpu/models/projector.py``, selected by
``model_config.encoder_projector``:

  simple_linear    concat x k frames, one Linear
  linear           concat x k frames, 2048 ReLU, Linear to llm_dim
  cov1d-linear     Conv1d (kernel k, stride k), ReLU, 2048 ReLU, llm_dim
  q-former         BLIP-2 querying transformer (post-LN, cross-attention
                   every 2nd layer, exact GELU, eps 1e-12)
  cross-attention  posterior queries over the LLM's embedding matrix
  linear-silu      LayerNorm, 2048 SiLU, llm_dim (the published TASU one)

Frame concatenation drops the ``T % k`` tail frames; lengths are divided
by :func:`downsample_rate` by the caller.  Every LayerNorm goes through
``LayerNormFn`` (the CUDA kernels on CUDA tensors).  The cross-attention
projector attends over all ~152k embedding rows with an online softmax
over chunks of 8192 rows in fp32, so no [B, T, h, V] scores exist at once;
while gradients are recorded each chunk runs under
``torch.utils.checkpoint``, so the backward recomputes a chunk's scores
instead of keeping every chunk's.  The embedding matrix is detached, as
the JAX package stops its gradient.  The q-former's attention is plain
PyTorch, as the JAX ``_qf_attention`` is plain jnp.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ps_slm_tpu_torch.models.layers import LayerNorm, linear_init_, normal_, uniform_
from ps_slm_tpu_torch.parallel.tensor import parallel_mlp

HIDDEN = 2048        # the concat / cov1d / linear-silu projectors' hidden width
CA_CHUNK = 8192      # embedding rows a chunk of the cross-attention softmax
QF_HIDDEN = 768      # the q-former's width (Blip2QFormer's)
QF_FFN = 3072        # its feed-forward width
QF_CROSS_EVERY = 2   # cross-attention on every 2nd layer, from the first


def frame_concat(x: torch.Tensor, k: int) -> torch.Tensor:
    """[B, T, D] -> [B, T // k, D * k], the ``T % k`` tail frames dropped."""
    if k == 1:
        return x
    b, t, d = x.shape
    t2 = (t // k) * k
    return x[:, :t2].reshape(b, t2 // k, d * k)


def _init_linears(generator: torch.Generator, *linears: nn.Linear) -> None:
    for lin in linears:
        linear_init_(lin, generator)


class SimpleLinearProjector(nn.Module):
    def __init__(self, encoder_dim: int, llm_dim: int, k: int):
        super().__init__()
        self.k = k
        self.map = nn.Linear(encoder_dim * k, llm_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.map(frame_concat(x, self.k))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        _init_linears(generator, self.map)


class ConcatProjector(nn.Module):
    """``linear``: concat x k -> 2048 ReLU -> llm_dim."""

    def __init__(self, encoder_dim: int, llm_dim: int, k: int):
        super().__init__()
        self.k = k
        self.linear1 = nn.Linear(encoder_dim * k, HIDDEN)
        self.linear2 = nn.Linear(HIDDEN, llm_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(torch.relu(self.linear1(frame_concat(x, self.k))))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        _init_linears(generator, self.linear1, self.linear2)


class Cov1dProjector(nn.Module):
    """``cov1d-linear``: Conv1d(kernel k, stride k, no padding) -> ReLU ->
    2048 ReLU -> llm_dim."""

    def __init__(self, encoder_dim: int, llm_dim: int, k: int):
        super().__init__()
        self.k = k
        self.conv = nn.Conv1d(encoder_dim, encoder_dim, k, stride=k)
        self.linear1 = nn.Linear(encoder_dim, HIDDEN)
        self.linear2 = nn.Linear(HIDDEN, llm_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.conv(x.transpose(1, 2)).transpose(1, 2))
        return self.linear2(torch.relu(self.linear1(y)))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.conv.in_channels * self.k)
        uniform_(self.conv.weight, bound, generator)
        uniform_(self.conv.bias, bound, generator)
        _init_linears(generator, self.linear1, self.linear2)


class LinearSiLUProjector(nn.Module):
    def __init__(self, encoder_dim: int, llm_dim: int):
        super().__init__()
        self.norm = LayerNorm(encoder_dim)
        self.ffn1 = nn.Linear(encoder_dim, HIDDEN)
        self.ffn2 = nn.Linear(HIDDEN, llm_dim)
        # this rank's place in a tensor-parallel group (parallel/mesh.py):
        # its block of ffn1's columns and of ffn2's rows
        self.tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(x)
        if self.tp is None:
            return self.ffn2(F.silu(self.ffn1(y)))
        return parallel_mlp(y, self.ffn1, F.silu, self.ffn2, self.tp)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.norm.init_weights(generator)
        _init_linears(generator, self.ffn1, self.ffn2)
        self.ffn2.bias.zero_()  # the reference zero-inits ffn[2].bias


def _ca_chunk(q, kv_c, m, l, acc):
    """One chunk of the online softmax: q [B,T,h,d] fp32 (scaled), kv_c
    [C,h,d] fp32; carries m, l [B,T,h] and acc [B,T,h,d]."""
    s = torch.einsum("bthd,vhd->bthv", q, kv_c)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("bthv,vhd->bthd", p, kv_c)
    return m_new, l, acc


class CrossAttentionProjector(nn.Module):
    """Q = post @ W_q; K = V = the LLM's embedding matrix (detached), ``heads``
    heads; softmax over the whole vocabulary.  Under tensor parallelism
    the caller gathers the vocabulary-sharded table whole on every rank
    once a forward (``models/tasu.py::_project``) and every rank attends
    over all of it; the JAX package's GSPMD may partition the softmax
    instead.  It is not the default projector."""

    def __init__(self, encoder_dim: int, llm_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.w_q = nn.Linear(encoder_dim, llm_dim, bias=False)

    def forward(self, post: torch.Tensor, llm_embed: torch.Tensor,
                chunk: int = CA_CHUNK) -> torch.Tensor:
        b, t, _ = post.shape
        q = self.w_q(post)
        d_model = q.shape[-1]
        h = self.heads
        d = d_model // h
        # the scale on the scores, as (q . k) * scale
        q = q.reshape(b, t, h, d).float() * (d ** -0.5)
        kv = llm_embed.detach().float()
        m = torch.full((b, t, h), float("-inf"), device=q.device)
        l = torch.zeros(b, t, h, device=q.device)
        acc = torch.zeros(b, t, h, d, device=q.device)
        remat = torch.is_grad_enabled() and q.requires_grad
        for start in range(0, kv.shape[0], chunk):
            kv_c = kv[start:start + chunk].reshape(-1, h, d)
            if remat:
                m, l, acc = checkpoint(_ca_chunk, q, kv_c, m, l, acc, use_reentrant=False,
                                       preserve_rng_state=False)
            else:
                m, l, acc = _ca_chunk(q, kv_c, m, l, acc)
        return (acc / l[..., None]).reshape(b, t, d_model).to(post.dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        _init_linears(generator, self.w_q)


def _qf_attention(q, k, v, heads: int, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    b, tq, d = q.shape
    tk = k.shape[1]
    hd = d // heads
    s = torch.einsum("bqhd,bkhd->bhqk", q.reshape(b, tq, heads, hd),
                     k.reshape(b, tk, heads, hd)).float() / math.sqrt(hd)
    if mask is not None:
        s = torch.where(mask[:, None, None, :], s, -1e30)
    a = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", a, v.reshape(b, tk, heads, hd)).reshape(b, tq, d)


class QFormerLayer(nn.Module):
    def __init__(self, encoder_dim: int, cross: bool):
        super().__init__()
        self.self_q, self.self_k, self.self_v, self.self_o = (
            nn.Linear(QF_HIDDEN, QF_HIDDEN) for _ in range(4))
        self.ln_self = LayerNorm(QF_HIDDEN, eps=1e-12)
        self.cross = cross
        if cross:
            self.cross_q = nn.Linear(QF_HIDDEN, QF_HIDDEN)
            self.cross_k = nn.Linear(encoder_dim, QF_HIDDEN)
            self.cross_v = nn.Linear(encoder_dim, QF_HIDDEN)
            self.cross_o = nn.Linear(QF_HIDDEN, QF_HIDDEN)
            self.ln_cross = LayerNorm(QF_HIDDEN, eps=1e-12)
        self.ffn1 = nn.Linear(QF_HIDDEN, QF_FFN)
        self.ffn2 = nn.Linear(QF_FFN, QF_HIDDEN)
        self.ln_ffn = LayerNorm(QF_HIDDEN, eps=1e-12)
        # this rank's place in a tensor-parallel group (parallel/mesh.py):
        # its block of ffn1's columns and of ffn2's rows
        self.tp = None

    def forward(self, h, x, atts, heads: int):
        sa = _qf_attention(self.self_q(h), self.self_k(h), self.self_v(h), heads)
        h = self.ln_self(h + self.self_o(sa))
        if self.cross:
            ca = _qf_attention(self.cross_q(h), self.cross_k(x), self.cross_v(x), heads,
                               mask=atts)
            h = self.ln_cross(h + self.cross_o(ca))
        if self.tp is not None:
            return self.ln_ffn(h + parallel_mlp(h, self.ffn1, F.gelu, self.ffn2, self.tp))
        return self.ln_ffn(h + self.ffn2(F.gelu(self.ffn1(h))))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        lins = [self.self_q, self.self_k, self.self_v, self.self_o, self.ffn1, self.ffn2]
        norms = [self.ln_self, self.ln_ffn]
        if self.cross:
            lins += [self.cross_q, self.cross_k, self.cross_v, self.cross_o]
            norms.append(self.ln_cross)
        _init_linears(generator, *lins)
        for n in norms:
            n.init_weights(generator)


class QFormerProjector(nn.Module):
    """``query_len`` learned queries through ``layers`` Blip2QFormer layers
    (cross-attention on every 2nd, from the first), then Linear to llm_dim
    and a LayerNorm.  Returns [B, query_len, llm_dim]."""

    def __init__(self, encoder_dim: int, llm_dim: int, layers: int, heads: int, query_len: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Parameter(torch.empty(1, query_len, QF_HIDDEN))
        self.ln_embed = LayerNorm(QF_HIDDEN, eps=1e-12)
        self.layers = nn.ModuleList(
            QFormerLayer(encoder_dim, i % QF_CROSS_EVERY == 0) for i in range(layers))
        self.out = nn.Linear(QF_HIDDEN, llm_dim)
        self.out_norm = LayerNorm(llm_dim)

    def forward(self, x: torch.Tensor, atts: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, encoder_dim]; atts [B, T] bool, the valid frames."""
        h = self.ln_embed(self.query.expand(x.shape[0], -1, -1).to(x.dtype))
        for layer in self.layers:
            h = layer(h, x, atts, self.heads)
        return self.out_norm(self.out(h))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        normal_(self.query, 1.0, generator)
        self.ln_embed.init_weights(generator)
        for layer in self.layers:
            layer.init_weights(generator)
        _init_linears(generator, self.out)
        self.out_norm.init_weights(generator)


def build_projector(model_cfg) -> nn.Module:
    name = model_cfg.encoder_projector
    enc, llm, k = model_cfg.encoder_dim, model_cfg.llm_dim, model_cfg.encoder_projector_ds_rate
    if name == "linear-silu":
        return LinearSiLUProjector(enc, llm)
    if name == "simple_linear":
        return SimpleLinearProjector(enc, llm, k)
    if name == "linear":
        return ConcatProjector(enc, llm, k)
    if name == "cov1d-linear":
        return Cov1dProjector(enc, llm, k)
    if name == "cross-attention":
        return CrossAttentionProjector(enc, llm, model_cfg.ca_heads)
    if name == "q-former":
        return QFormerProjector(enc, llm, model_cfg.qformer_layers, model_cfg.qformer_heads,
                                model_cfg.query_len)
    raise KeyError(f"unknown projector {name!r}; known: {sorted(PROJECTORS)}")


PROJECTORS = ("simple_linear", "linear", "cov1d-linear", "linear-silu", "cross-attention",
              "q-former")


def downsample_rate(model_cfg) -> int:
    """``k`` used for length bookkeeping."""
    if model_cfg.encoder_projector in ("linear-silu", "cross-attention"):
        return 1
    return model_cfg.encoder_projector_ds_rate
