"""PyTorch port: tensor parallelism written out (``parallel/tensor.py``)
against the whole tensors, in one process.

T ranks are T threads of this process whose collectives meet at a
barrier (:class:`ThreadShards`), so every rank runs the port's own code,
forward and backward, at T = 2 and 3:

* the vocabulary-parallel CE (``ops/ce_loss.py::_ce_sums`` with
  ``vocab``, and the gathered form) against the whole table's: the summed
  NLL, the argmax-correct count with ties inside a block and across
  blocks (the global first maximum counts), ignored labels, and the
  gradients of the hidden states and of each rank's rows;
* the vocabulary-parallel lookup (exact, its gradient exact) and
  voca_trans' mix with a ``v_real`` that cuts a block;
* the encoder's ``qkv`` held by heads and put back, bit for bit;
* a SANM layer (``encoders0``'s 24 -> 16 and a residual 16 -> 16) and a
  Qwen2 block with LoRA (dropout masks drawn at the whole width), a
  prefix or llama-adapter, cut by ``parallel/mesh.py``'s own
  ``shard_sanm`` / ``shard_block``: outputs and every gradient against
  the whole layer's (a block's gradients gathered, the whole adapters'
  and FSMN kernel's summed over the ranks).

Tolerances (absolute and relative; fp32, the partial sums add in another
order): 1e-6 for the vocabulary's CE and mix; for the layers 1e-5 of each
tensor's largest magnitude (a weight's gradient sums large products over
every row, and its small elements are what is left of them: LoRA's
``lora_a`` 3.9e-5 apart on 68.8); the lookup and the layout exact.  CPU
time alone: ~5 s.
"""

import copy
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ps_slm_tpu_torch.config import PeftConfig
from ps_slm_tpu_torch.models import lora
from ps_slm_tpu_torch.models.qwen2 import Qwen2Config, Qwen2Model
from ps_slm_tpu_torch.models.sensevoice import SANMLayer, SenseVoiceConfig
from ps_slm_tpu_torch.ops.ce_loss import _ce_sums, gathered_ce_loss
from ps_slm_tpu_torch.parallel import mesh
from ps_slm_tpu_torch.parallel.tensor import (
    Shards, from_shards, qkv_rows, vocab_embed, vocab_mix,
)

TOL = dict(atol=1e-6, rtol=1e-6)
LAYER_TOL = 1e-5        # of each tensor's largest magnitude


class _Hub:
    """Where the threads' collectives meet."""

    def __init__(self, n):
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n

    def exchange(self, rank, t):
        self.slots[rank] = t.detach().clone()
        self.barrier.wait()
        out = torch.stack(self.slots)
        self.barrier.wait()
        return out


class ThreadShards(Shards):
    """A rank of a group of threads: the sum and gather through a hub."""

    def __init__(self, rank, size, hub):
        super().__init__(rank, size)
        self.hub = hub

    def all_reduce(self, t):
        return t.copy_(self.hub.exchange(self.rank, t).sum(0))

    def all_gather(self, t):
        return self.hub.exchange(self.rank, t)


def on_shards(size, fn):
    """``fn(shards)`` on ``size`` threads at once; their results by rank."""
    hub, out, errors = _Hub(size), [None] * size, []

    def run(r):
        try:
            out[r] = fn(ThreadShards(r, size, hub))
        except BaseException as e:          # noqa: BLE001 - re-raised below
            errors.append(e)
            hub.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(size)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return out


def _close(got, want, what="", tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), **tol, err_msg=what)


def _near(got, want, what):
    """Within LAYER_TOL of ``want``'s largest magnitude."""
    err = float((got - want).abs().max())
    assert err <= LAYER_TOL * float(want.abs().max()), f"{what}: {err} of {want.abs().max()}"


# ----------------------------------------------------------------------------
# the vocabulary
# ----------------------------------------------------------------------------

V, H = 30, 8


def _ce_inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(V, H, generator=g)
    w[17] = w[5]             # a tie across blocks (T = 2: 15 per block; T = 3: 10)
    w[3] = w[2]              # a tie inside the first block
    x = torch.randn(3, 7, H, generator=g)
    x[0, 0] = w[5] * 4.0     # rows whose argmax is a tie: 5 before 17
    x[0, 1] = w[2] * 4.0     # and 2 before 3
    y = torch.randint(0, V, (3, 7), generator=g)
    y[0, 0], y[0, 1], y[0, 2] = 5, 3, 17      # the first max counts; the later tie does not
    y[1, 2:] = -100
    return x, w, y, y != -100


@pytest.mark.parametrize("size", [2, 3])
def test_vocab_parallel_ce_sums_equal_the_whole_table(size):
    x, w, y, valid = _ce_inputs()
    safe = torch.where(valid, y, 0)
    xw, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
    nll, correct = _ce_sums(xw, ww, safe, valid)
    nll.backward()
    assert int(correct) == int(((torch.einsum("bth,vh->btv", x, w).argmax(-1) == safe)
                                & valid).sum())

    def rank(shards):
        xr = x.clone().requires_grad_()
        wr = w[shards.block(V)].clone().requires_grad_()
        n, c = _ce_sums(xr, wr, safe, valid, shards)
        n.backward()
        return n.detach(), c, xr.grad, wr.grad

    out = on_shards(size, rank)
    for r, (n, c, gx, gw) in enumerate(out):
        _close(n, nll.detach(), f"nll rank {r}")
        assert int(c) == int(correct), r
        _close(gx, xw.grad, f"hidden grad rank {r}")
    _close(torch.cat([o[3] for o in out]), ww.grad, "table grad")


@pytest.mark.parametrize("size", [2, 3])
def test_vocab_parallel_gathered_ce_equals_the_whole_table(size):
    x, w, y, _ = _ce_inputs(1)
    want = gathered_ce_loss(x, w, y, max_valid=4)

    def rank(shards):
        return gathered_ce_loss(x, w[shards.block(V)], y, max_valid=4, vocab=shards)

    for got in on_shards(size, rank):
        for a, b in zip(got, want):
            _close(a, b)


@pytest.mark.parametrize("size", [2, 3])
def test_vocab_embed_is_the_whole_lookup(size):
    g = torch.Generator().manual_seed(2)
    table = torch.randn(V, H, generator=g)
    ids = torch.randint(0, V, (4, 9), generator=g)
    whole = table.clone().requires_grad_()
    want = torch.nn.functional.embedding(ids, whole)
    cot = torch.randn(want.shape, generator=g)
    (want * cot).sum().backward()

    def rank(shards):
        t = table[shards.block(V)].clone().requires_grad_()
        got = vocab_embed(t, ids, shards)
        (got * cot).sum().backward()
        return got.detach(), t.grad

    out = on_shards(size, rank)
    for got, _ in out:
        assert torch.equal(got, want.detach())
    assert torch.equal(torch.cat([o[1] for o in out]), whole.grad)


@pytest.mark.parametrize("size,v_real", [(2, 29), (3, 17), (3, 9)])
def test_vocab_mix_with_v_real_cutting_a_block(size, v_real):
    g = torch.Generator().manual_seed(3)
    table = torch.randn(V, H, generator=g)
    probs = torch.softmax(torch.randn(2, 5, v_real, generator=g), -1)
    pw, tw = probs.clone().requires_grad_(), table.clone().requires_grad_()
    want = pw @ tw[:v_real]
    cot = torch.randn(want.shape, generator=g)
    (want * cot).sum().backward()

    def rank(shards):
        p, t = probs.clone().requires_grad_(), table[shards.block(V)].clone().requires_grad_()
        got = vocab_mix(p, t, v_real, shards)
        (got * cot).sum().backward()
        return got.detach(), p.grad, t.grad

    out = on_shards(size, rank)
    for got, gp, _ in out:
        _close(got, want.detach())
        _close(gp, pw.grad)
    _close(torch.cat([o[2] for o in out]), tw.grad)


# ----------------------------------------------------------------------------
# the encoder's qkv layout, a SANM layer and a Qwen2 block
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("size", [2, 4])
def test_qkv_by_heads_and_back(size):
    d, heads = 16, 4
    w = torch.randn(3 * d, 24)
    parts = [w[qkv_rows(d, size, r)] for r in range(size)]
    for r, part in enumerate(parts):
        q, k, v = part.chunk(3)
        cols = slice(r * d // size, (r + 1) * d // size)      # its heads' channels
        assert torch.equal(q, w[:d][cols]) and torch.equal(k, w[d:2 * d][cols])
        assert torch.equal(v, w[2 * d:][cols])
    assert heads % size == 0
    assert torch.equal(from_shards(parts, 0, by_heads=True), w)
    b = torch.randn(3 * d)
    assert torch.equal(from_shards([b[qkv_rows(d, size, r)] for r in range(size)], 0, True), b)


def _cut(layer, shards, fn):
    """A copy of ``layer`` cut by ``fn`` (``mesh.shard_sanm`` / ``shard_block``)
    for rank ``shards``; its record of what was cut."""
    ctx = SimpleNamespace(shards=shards, tp={}, tensor_sum=set())
    mine = copy.deepcopy(layer)
    fn(ctx, mine)
    return mine, ctx


def _check_grads(whole, out, what):
    """Every parameter's gradient: a cut one's blocks gathered, a whole
    one's (partial on each rank) summed, the rest rank 0's."""
    for name, p in whole.named_parameters():
        if p.grad is None:
            continue
        ctx = out[0][1]
        key = f"l.{name}"
        grads = [dict(m.named_parameters())[name].grad for m, _ in out]
        if key in ctx.tp:
            got = from_shards(grads, *ctx.tp[key])
        elif key in ctx.tensor_sum:
            got = sum(grads)
        else:
            got = grads[0]
            for g in grads[1:]:
                _near(g, got, f"{what} {name} differs between ranks")
        _near(got, p.grad, f"{what} {name}")


@pytest.mark.parametrize("in_size", [24, 16])
def test_sharded_sanm_layer_equals_the_whole_layer(in_size):
    cfg = SenseVoiceConfig.tiny(attention_heads=2)
    g = torch.Generator().manual_seed(4)
    whole = SANMLayer(in_size, cfg)
    whole.init_weights(g)
    x = torch.randn(3, 11, in_size, generator=g)
    mask = torch.arange(11)[None] < torch.tensor([11, 7, 4])[:, None]
    xw = x.clone().requires_grad_()
    want = whole(xw, mask)
    cot = torch.randn(want.shape, generator=g)
    (want * cot).sum().backward()

    def rank(shards):
        layer, ctx = _cut(whole, shards, lambda c, m: mesh.shard_sanm(c, "l", m))
        layer.zero_grad()
        xr = x.clone().requires_grad_()
        got = layer(xr, mask)
        (got * cot).sum().backward()
        return layer, ctx, got.detach(), xr.grad

    out = on_shards(2, rank)
    for _, _, got, gx in out:
        _near(got, want.detach(), "output")
        _near(gx, xw.grad, "input grad")
    assert out[0][0].qkv.weight.shape == (3 * 8, in_size)
    _check_grads(whole, [(m, c) for m, c, *_ in out], "sanm")


PEFT = {"lora": dict(peft_method="lora", r=4, lora_alpha=8,
                     target_modules=list(lora.LORA_TARGETS)),
        "prefix": dict(peft_method="prefix", num_virtual_tokens=3),
        "llama_adapter": dict(peft_method="llama_adapter", adapter_len=3, adapter_layers=1)}


@pytest.mark.parametrize("method", sorted(PEFT))
def test_sharded_block_with_peft_equals_the_whole_block(method):
    g = torch.Generator().manual_seed(5)
    llm = Qwen2Model(Qwen2Config.tiny(num_hidden_layers=1))
    llm.init_weights(g)
    lora.add_peft(llm, PeftConfig(**PEFT[method]), g)
    with torch.no_grad():
        for name, p in llm.named_parameters():
            if name.endswith(("lora_b", "adaption_gate")):
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)   # the deltas matter
    whole = llm.layers[0]
    x = torch.randn(2, 6, 64, generator=g)
    pos = torch.arange(6)[None].expand(2, -1)
    mask = torch.ones(2, 6, dtype=torch.bool)
    mask[1, -2:] = False
    rate = 0.3 if method == "lora" else 0.0
    keep = lora.lora_dropout_masks(whole, x.shape, rate, g, "cpu") if rate else None
    xw = x.clone().requires_grad_()
    want = whole(xw, pos, mask, lora_keep=keep, lora_rate=rate)
    cot = torch.randn(want.shape, generator=g)
    (want * cot).sum().backward()

    def rank(shards):
        layer, ctx = _cut(whole, shards,
                          lambda c, m: mesh.shard_block(c, "l", m, llm.cfg))
        layer.zero_grad()
        xr = x.clone().requires_grad_()
        got = layer(xr, pos, mask, lora_keep=keep, lora_rate=rate)
        (got * cot).sum().backward()
        return layer, ctx, got.detach(), xr.grad

    out = on_shards(2, rank)
    for _, _, got, gx in out:
        _near(got, want.detach(), "output")
        _near(gx, xw.grad, "input grad")
    assert out[0][0].q_proj.weight.shape == (32, 64)
    assert out[0][1].tensor_sum                   # the whole adapters: summed
    _check_grads(whole, [(m, c) for m, c, *_ in out], method)
