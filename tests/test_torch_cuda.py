"""PyTorch port: the CUDA kernels against their plain versions, on the card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false (the decision is taken inside the fixture, never at import).  Run on
a machine with an NVIDIA H100:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: fp32 2e-5 (sums in another order); bf16 1e-2 relative and
absolute, one bf16 rounding step of the same fp32 value.  Weight gradients
sum over every row, so their absolute tolerance is scaled by the row
count's square root.  The repair test (gradients through the CUDA wrappers)
holds the card's fp32 gradients at 1e-4 against a float64 reference by
plain autograd: a whole attention and two norms.  The decode slice: the
waveform front end and one small decode CLI run, card against CPU.  The
training slice: the front end's training draws made on the card (masks in
bounds, the same features as the CPU with those draws), the prefetcher's
side-stream copy under a busy stream, remat bit-identical to no remat, and
a train-state save/restore that continues bit-identically.  The serving
slice: the int8 / int4 weight and int8 KV codes and scales bit-equal to the
CPU's.  Encoder training and the projectors: flash forward and backward at
the encoder step's 4/4 non-causal ragged rows, the LayerNorm forward and
backward at 560 / 512 with dw/db and at the q-former's 768 (eps 1e-12) and
1536 (its output norm, eps 1e-5); the CTC loss, its gradient (twice bit-identical: no atomics) and the
Viterbi on the card against the CPU (fp32 1e-5; the alignment equal).
The DeepSeek-V3 slice: the flash forward's q/k 192, v 128 instantiation at
a pool prefill's shapes (and no backward there), the grouped expert
kernels at Moonlight's widths (a decode step and a skewed prefill), and
the captured MoE pool against the eager one, bit for bit.
"""

import pytest
import torch

from ps_slm_tpu_torch.models.layers import layer_norm
from ps_slm_tpu_torch.models.qwen2 import rms_norm
from ps_slm_tpu_torch.ops import flash_attention as fa
from ps_slm_tpu_torch.ops import norms
from ps_slm_tpu_torch.ops.attention import attention

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5), torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [24, 560, 1536, 25055])
def test_norm_kernels_match_plain(dev, dtype, d):
    g = torch.Generator(device=dev).manual_seed(d)
    x = (torch.randn(37, d, device=dev, generator=g) * 3 + 1).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(dtype)
    b = (0.1 * torch.randn(d, device=dev, generator=g)).to(dtype)
    n0 = norms.layer_norm_fwd.launches
    got = norms.layer_norm_fwd(x, w, b)
    torch.cuda.synchronize()
    assert norms.layer_norm_fwd.launches == n0 + 1
    for g_, r_ in zip(got, norms.layer_norm_ref(x, w, b)):
        torch.testing.assert_close(g_.float(), r_.float(), **TOL[dtype])
    n0 = norms.rms_norm_fwd.launches
    got = norms.rms_norm_fwd(x, w)
    torch.cuda.synchronize()
    assert norms.rms_norm_fwd.launches == n0 + 1
    for g_, r_ in zip(got, norms.rms_norm_ref(x, w)):
        torch.testing.assert_close(g_.float(), r_.float(), **TOL[dtype])


# (B, S, Hq, Hkv, causal, window starts, window ends): the main paths'
# shapes, and the edges of the bf16 kernels' 64-row tiles and 16-row warp
# fragments (S of 1, 17, 64, 65 and 130; a window that starts or ends
# mid-tile; a row with no valid key; causal with left padding; GQA 6/1)
CASES = {
    "encoder": (4, 516, 4, 4, False, [0] * 4, [516, 404, 304, 260]),
    # encoder training: 8 ragged rows of frames + 4 queries, windows [0, len)
    "encoder_train": (8, 104, 4, 4, False, [0] * 8, [104, 90, 71, 60, 104, 45, 83, 38]),
    "prefill_left_padded": (4, 543, 12, 2, True, [0, 112, 212, 543], [543] * 4),
    "ragged": (2, 70, 2, 1, True, [0, 0], [70, 33]),
    "s1": (3, 1, 4, 4, False, [0, 0, 1], [1, 0, 1]),
    "s17_gqa6_left_padded": (2, 17, 6, 1, True, [3, 0], [17, 17]),
    "s64": (2, 64, 12, 2, True, [0, 5], [64, 64]),
    "s65_mid_window": (3, 65, 12, 2, False, [37, 0, 0], [65, 0, 64]),
    "s130_gqa6_mid_window": (3, 130, 6, 1, True, [70, 13, 0], [130, 100, 0]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_kernel_matches_plain(dev, dtype, case):
    b, s, hq, hkv, causal, starts, ends = CASES[case]
    g = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn(b, s, hq, fa.HEAD_DIM, device=dev, generator=g).to(dtype)
    k = torch.randn(b, s, hkv, fa.HEAD_DIM, device=dev, generator=g).to(dtype)
    v = torch.randn(b, s, hkv, fa.HEAD_DIM, device=dev, generator=g).to(dtype)
    pos = torch.arange(s, device=dev)
    mask = ((pos[None] >= torch.tensor(starts, device=dev)[:, None])
            & (pos[None] < torch.tensor(ends, device=dev)[:, None]))
    start, end = fa.window_from_mask(mask, b, s, dev)
    n0 = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, start, end, causal=causal, scale=0.088)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == n0 + 1
    ref_out, ref_lse = fa.flash_attention_ref(q, k, v, start, end, causal=causal, scale=0.088)
    assert not torch.isnan(out).any()
    torch.testing.assert_close(out.float(), ref_out.float(), **TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, **TOL[torch.float32])


def test_flash_kernel_rejects_other_head_dims(dev):
    q = torch.zeros(1, 4, 2, 64, device=dev)
    win = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q, q, q, win, win + 4, causal=False, scale=1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# LayerNorm backward: (5, 25055) and (3, 263) leave blocks with one row or
# none; at d = 30011 the kernel reads the columns past the 25 088 it holds
# in registers again and keeps its partial rows in device memory
@pytest.mark.parametrize("n,d", [(37, 24), (3, 263), (700, 560), (2715, 1536), (5, 25055),
                                 (300, 25055), (7, 30011)])
def test_norm_backward_kernels_match_plain(dev, dtype, n, d):
    g_ = torch.Generator(device=dev).manual_seed(n + d)
    x = (torch.randn(n, d, device=dev, generator=g_) * 3 + 1).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device=dev, generator=g_)).to(dtype)
    b = (0.1 * torch.randn(d, device=dev, generator=g_)).to(dtype)
    g = torch.randn(n, d, device=dev, generator=g_).to(dtype)
    tol = TOL[dtype]
    wtol = dict(tol, atol=tol["atol"] * n ** 0.5)
    _, mu, rstd = norms.layer_norm_ref(x, w, b)
    n0 = norms.layer_norm_bwd.launches
    got = norms.layer_norm_bwd(x, w, mu, rstd, g)
    torch.cuda.synchronize()
    assert norms.layer_norm_bwd.launches == n0 + 1
    for i, (a, e) in enumerate(zip(got, norms.layer_norm_bwd_ref(x, w, mu, rstd, g))):
        assert not torch.isnan(a).any()
        torch.testing.assert_close(a.float(), e.float(), **(tol if i == 0 else wtol))
    _, rstd = norms.rms_norm_ref(x, w)
    n0 = norms.rms_norm_bwd.launches
    got = norms.rms_norm_bwd(x, w, rstd, g)
    torch.cuda.synchronize()
    assert norms.rms_norm_bwd.launches == n0 + 1
    for i, (a, e) in enumerate(zip(got, norms.rms_norm_bwd_ref(x, w, rstd, g))):
        torch.testing.assert_close(a.float(), e.float(), **(tol if i == 0 else wtol))


BWD_CASES = {
    "training": (5, 543, 12, 2, True, [0] * 5, [543] * 5),
    # a left-padded row, a right-padded row and a row with no valid key
    "ragged": (3, 70, 4, 2, True, [13, 0, 0], [70, 33, 0]),
    "encoder": (2, 130, 4, 4, False, [0, 0], [130, 77]),
    "encoder_train": (8, 104, 4, 4, False, [0] * 8, [104, 90, 71, 60, 104, 45, 83, 38]),
    "s1": (2, 1, 4, 4, False, [0, 0], [1, 0]),
    "s17_gqa6_left_padded": (2, 17, 6, 1, True, [3, 0], [17, 17]),
    "s64": (2, 64, 12, 2, True, [0, 5], [64, 64]),
    "s65_mid_window": (3, 65, 12, 2, False, [37, 0, 0], [65, 0, 64]),
    "s130_gqa6_mid_window": (3, 130, 6, 1, True, [70, 13, 0], [130, 100, 0]),
}


def _bwd_inputs(dev, dtype, b, s, hq, hkv, causal, starts, ends):
    g_ = torch.Generator(device=dev).manual_seed(s + hq)
    q, do = (torch.randn(b, s, hq, fa.HEAD_DIM, device=dev, generator=g_).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, s, hkv, fa.HEAD_DIM, device=dev, generator=g_).to(dtype)
            for _ in range(2))
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    end = torch.tensor(ends, dtype=torch.int32, device=dev)
    kw = dict(causal=causal, scale=fa.HEAD_DIM ** -0.5)
    out, lse = fa.flash_attention_ref(q, k, v, start, end, **kw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return (q, k, v, start, end, out, lse, do, delta), kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_backward_kernels_match_plain(dev, dtype, case):
    args, kw = _bwd_inputs(dev, dtype, *BWD_CASES[case])
    q, k, v, start, end, out, lse, do, delta = args
    n0 = (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches)
    dq = fa.flash_attention_dq(*args, **kw)
    dk, dv = fa.flash_attention_dkv(*args, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches) == (n0[0] + 1, n0[1] + 1)
    want = fa.flash_attention_bwd_ref(q, k, v, start, end, out, lse, do, **kw)
    for a, e in zip((dq, dk, dv), want):
        assert not torch.isnan(a).any()
        torch.testing.assert_close(a.float(), e.float(), **TOL[dtype])
    empty = (lse == fa.NEG_INF).transpose(1, 2)
    if case == "ragged":
        assert empty.any()
        assert not dq[empty].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_is_deterministic(dev, dtype):
    """Two calls give the same bits: dq has no cross-block sum, and the bf16
    dk/dv kernel sums its per-query-head partials in a fixed order, with no
    atomics."""
    args, kw = _bwd_inputs(dev, dtype, *BWD_CASES["training"])
    first = (fa.flash_attention_dq(*args, **kw), *fa.flash_attention_dkv(*args, **kw))
    second = (fa.flash_attention_dq(*args, **kw), *fa.flash_attention_dkv(*args, **kw))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_bwd_is_deterministic(dev, dtype):
    """Two calls give the same bits at the projector's width: each block's
    dw/db partials are summed in a fixed order."""
    g_ = torch.Generator(device=dev).manual_seed(7)
    n, d = 700, 25055
    x = (torch.randn(n, d, device=dev, generator=g_) * 3 + 1).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device=dev, generator=g_)).to(dtype)
    g = torch.randn(n, d, device=dev, generator=g_).to(dtype)
    _, mu, rstd = norms.layer_norm_ref(x, w, torch.zeros_like(w))
    first = norms.layer_norm_bwd(x, w, mu, rstd, g)
    second = norms.layer_norm_bwd(x, w, mu, rstd, g)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# The LayerNorm backward on both kernel routes (ops/norms.py::ln_bwd_route):
# (n, d, storage offset of x and g in elements, eps, route for bf16, route
# for fp32).  760 x 560 / 512 are the encoder training step's rows, 256 x
# 768 (eps 1e-12, where rstd is large) and 256 x 1536 the q-former's; 1792
# and 896 are the cap (3 584-byte rows), 1792 in fp32 past it; 263 and
# 25 055 are not whole 16-byte chunks; an odd storage offset misaligns a
# contiguous tensor; 5 rows leave most blocks without a row.
LN_BWD_ROUTE_CASES = {
    "n760_d560": (760, 560, 0, 1e-5, "vec", "vec"),
    "n760_d512": (760, 512, 0, 1e-5, "vec", "vec"),
    "n256_d768_eps1e-12": (256, 768, 0, 1e-12, "vec", "vec"),
    "n256_d1536": (256, 1536, 0, 1e-5, "vec", "wide"),
    "n37_d1792_cap": (37, 1792, 0, 1e-5, "vec", "wide"),
    "n37_d896_cap": (37, 896, 0, 1e-5, "vec", "vec"),
    "n5_d24": (5, 24, 0, 1e-5, "vec", "vec"),
    "n1_d512": (1, 512, 0, 1e-5, "vec", "vec"),
    "n300_d560_odd_offset": (300, 560, 1, 1e-5, "wide", "wide"),
    "n3_d263": (3, 263, 0, 1e-5, "wide", "wide"),
    "n5_d25055": (5, 25055, 0, 1e-5, "wide", "wide"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(LN_BWD_ROUTE_CASES))
def test_layer_norm_bwd_routes_match_plain(dev, dtype, case):
    """The backward with dw/db and with frozen weights (dw, db None) on
    the route the case names, each against its plain version; the route
    counter moves as ``ln_bwd_route`` says, once a call."""
    n, d, offset, eps, bf16_route, f32_route = LN_BWD_ROUTE_CASES[case]
    route = bf16_route if dtype == torch.bfloat16 else f32_route
    x, w, g = _norm_inputs(dev, dtype, n, d, offset, n + d + offset)
    b = torch.zeros_like(w) + 0.1
    dx0 = torch.empty_like(x)
    assert norms.ln_bwd_route(d, dtype, (x.data_ptr(), w.data_ptr(), g.data_ptr(),
                                         dx0.data_ptr())) == route
    tol = TOL[dtype]
    wtol = dict(tol, atol=tol["atol"] * n ** 0.5)
    _, mu, rstd = norms.layer_norm_ref(x, w, b, eps)
    want = norms.layer_norm_bwd_ref(x, w, mu, rstd, g)
    for weight_grad in (True, False):
        before, n0 = dict(norms.layer_norm_bwd.routes), norms.layer_norm_bwd.launches
        dx, dw, db = norms.layer_norm_bwd(x, w, mu, rstd, g, weight_grad=weight_grad)
        torch.cuda.synchronize()
        assert _route_moved(norms.layer_norm_bwd.routes, before) == [route]
        assert norms.layer_norm_bwd.launches == n0 + 1
        assert not torch.isnan(dx).any()
        torch.testing.assert_close(dx.float(), want[0].float(), **tol)
        if weight_grad:
            assert dw.dtype == dtype and db.dtype == dtype
            torch.testing.assert_close(dw.float(), want[1].float(), **wtol)
            torch.testing.assert_close(db.float(), want[2].float(), **wtol)
        else:
            assert dw is None and db is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [560, 512])
def test_layer_norm_bwd_of_a_padded_batch(dev, dtype, d):
    """The encoder's padded rows carry g = 0 and a finite rstd: their dx is
    exactly 0 and they add nothing to dw and db, which equal the plain
    version's over the valid rows alone."""
    lens = [95, 60, 33, 95, 12, 80, 95, 41]
    t = max(lens)
    x, w, g = _norm_inputs(dev, dtype, len(lens) * t, d, 0, d)
    valid = (torch.arange(t, device=dev)[None] < torch.tensor(lens, device=dev)[:, None]).reshape(-1)
    g[~valid] = 0
    b = torch.zeros_like(w)
    _, mu, rstd = norms.layer_norm_ref(x, w, b)
    assert torch.isfinite(rstd).all()
    before = dict(norms.layer_norm_bwd.routes)
    dx, dw, db = norms.layer_norm_bwd(x, w, mu, rstd, g)
    torch.cuda.synchronize()
    assert _route_moved(norms.layer_norm_bwd.routes, before) == ["vec"]
    assert torch.equal(dx[~valid], torch.zeros_like(dx[~valid]))
    tol = TOL[dtype]
    wtol = dict(tol, atol=tol["atol"] * sum(lens) ** 0.5)
    want = norms.layer_norm_bwd_ref(x[valid], w, mu[valid], rstd[valid], g[valid])
    torch.testing.assert_close(dx[valid].float(), want[0].float(), **tol)
    torch.testing.assert_close(dw.float(), want[1].float(), **wtol)
    torch.testing.assert_close(db.float(), want[2].float(), **wtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [560, 1536])
def test_layer_norm_bwd_vec_is_deterministic(dev, dtype, d):
    """Two calls give the same bits at the encoder training step's rows on
    the vectorised route (and at 1536: bf16's shared-memory sums, fp32's
    wide route): each block's warps add their sums in warp order and the
    partial rows are summed in a fixed order, with no atomics; the frozen
    call's dx is the same bits as the one with dw/db."""
    x, w, g = _norm_inputs(dev, dtype, 760, d, 0, 13)
    _, mu, rstd = norms.layer_norm_ref(x, w, torch.zeros_like(w))
    first = norms.layer_norm_bwd(x, w, mu, rstd, g)
    second = norms.layer_norm_bwd(x, w, mu, rstd, g)
    frozen = norms.layer_norm_bwd(x, w, mu, rstd, g, weight_grad=False)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)
    assert frozen[1:] == (None, None) and torch.equal(frozen[0], first[0])


# RMSNorm on both kernel routes (ops/norms.py::rms_route): (n, d, storage
# offset of x and g in elements, route for bf16, route for fp32).  1536 is
# the LLM's width (n 4: a decode step, 2715: the training step's merged
# rows); 1544 leaves lanes past the row's end idle; 1538 is not a whole
# number of 16-byte chunks; 1792 and 896 are the cap (3 584-byte rows); an
# odd storage offset misaligns a contiguous tensor.
RMS_ROUTE_CASES = {
    "n1_d1536": (1, 1536, 0, "vec", "general"),
    "n4_d1536": (4, 1536, 0, "vec", "general"),
    "n2715_d1536": (2715, 1536, 0, "vec", "general"),
    "d1544": (37, 1544, 0, "vec", "general"),
    "d1538": (37, 1538, 0, "general", "general"),
    "d1792_cap": (37, 1792, 0, "vec", "general"),
    "d896_cap": (37, 896, 0, "vec", "vec"),
    "d1536_odd_offset": (37, 1536, 1, "general", "general"),
    "d560_odd_offset": (300, 560, 1, "general", "general"),
}


def _norm_inputs(dev, dtype, n, d, offset, seed):
    """x, w, g for the norm route tests; x and g contiguous, ``offset``
    elements into their storage."""
    g_ = torch.Generator(device=dev).manual_seed(seed)

    def rows(scale, shift):
        base = torch.empty(n * d + offset, device=dev, dtype=dtype)
        out = base[offset:].view(n, d)
        out.copy_(torch.randn(n, d, device=dev, generator=g_) * scale + shift)
        return out

    x = rows(3, 1)
    w = (1 + 0.1 * torch.randn(d, device=dev, generator=g_)).to(dtype)
    return x, w, rows(1, 0)


def _route_moved(routes, before):
    return [r for r in routes if routes[r] != before[r]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(RMS_ROUTE_CASES))
def test_rms_norm_routes_match_plain(dev, dtype, case):
    """Forward, backward with dw and backward with frozen weights (dw None)
    on the route the case names, each against its plain version."""
    n, d, offset, bf16_route, f32_route = RMS_ROUTE_CASES[case]
    route = bf16_route if dtype == torch.bfloat16 else f32_route
    x, w, g = _norm_inputs(dev, dtype, n, d, offset, n + d)
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == bool(offset)
    tol = TOL[dtype]
    wtol = dict(tol, atol=tol["atol"] * n ** 0.5)
    before = dict(norms.rms_norm_fwd.routes)
    got = norms.rms_norm_fwd(x, w)
    torch.cuda.synchronize()
    assert _route_moved(norms.rms_norm_fwd.routes, before) == [route]
    for a, e in zip(got, norms.rms_norm_ref(x, w)):
        torch.testing.assert_close(a.float(), e.float(), **tol)
    _, rstd = norms.rms_norm_ref(x, w)
    want_dx, want_dw = norms.rms_norm_bwd_ref(x, w, rstd, g)
    for weight_grad in (True, False):
        before = dict(norms.rms_norm_bwd.routes)
        dx, dw = norms.rms_norm_bwd(x, w, rstd, g, weight_grad=weight_grad)
        torch.cuda.synchronize()
        assert _route_moved(norms.rms_norm_bwd.routes, before) == [route]
        assert not torch.isnan(dx).any()
        torch.testing.assert_close(dx.float(), want_dx.float(), **tol)
        if weight_grad:
            torch.testing.assert_close(dw.float(), want_dw.float(), **wtol)
        else:
            assert dw is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1536, 1538])
def test_rms_norm_bwd_is_deterministic(dev, dtype, d):
    """Two calls give the same bits, on either route: each block's dw
    partial row is summed in a fixed order, and the partial rows over
    blocks too, with no atomics."""
    x, w, g = _norm_inputs(dev, dtype, 2715, d, 0, 11)
    _, rstd = norms.rms_norm_ref(x, w)
    first = norms.rms_norm_bwd(x, w, rstd, g)
    second = norms.rms_norm_bwd(x, w, rstd, g)
    frozen = norms.rms_norm_bwd(x, w, rstd, g, weight_grad=False)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert frozen[1] is None and torch.equal(frozen[0], first[0])


# The LayerNorm forward's routes (ops/norms.py::ln_route) by width: bf16,
# fp32.  24 to 1792 bf16 are whole 16-byte chunks up to the cap (3 584
# bytes; 512 and 560 are the encoder's widths); 1800 is one chunk past it;
# 25 055 is the projector's norm over the CTC posterior, whose rows shift
# their 16-byte alignment from row to row (staged in bf16; held in fp32,
# whose four row buffers do not fit in shared memory); 30 011 is held in
# bf16 too.  At an odd storage offset the rows the cap takes leave the
# vectorised route.
LN_ROUTES = {24: ("vec", "vec"), 512: ("vec", "vec"), 560: ("vec", "vec"),
             1792: ("vec", "staged"), 1800: ("staged", "staged"),
             25055: ("staged", "held"), 30011: ("held", "held")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 37, 2580])
@pytest.mark.parametrize("d", sorted(LN_ROUTES))
def test_layer_norm_routes_match_plain(dev, dtype, n, d):
    """The forward on the route the width names, at x's storage offset 0
    and 1, against its plain version (y at the dtype's tolerance, mu and
    rstd at fp32's); then the backward fed the forward's statistics."""
    route = LN_ROUTES[d][dtype == torch.float32]
    tol = TOL[dtype]
    wtol = dict(tol, atol=tol["atol"] * n ** 0.5)
    for offset in (0, 1):
        x, w, g = _norm_inputs(dev, dtype, n, d, offset, n + d + offset)
        b = (0.1 * torch.randn(d, device=dev, generator=torch.Generator(device=dev).manual_seed(d))).to(dtype)
        want = "general" if offset and route == "vec" else route
        before = dict(norms.layer_norm_fwd.routes)
        y, mu, rstd = norms.layer_norm_fwd(x, w, b)
        torch.cuda.synchronize()
        assert _route_moved(norms.layer_norm_fwd.routes, before) == [want]
        r_y, r_mu, r_rstd = norms.layer_norm_ref(x, w, b)
        assert not torch.isnan(y).any()
        torch.testing.assert_close(y.float(), r_y.float(), **tol)
        torch.testing.assert_close(mu, r_mu, **TOL[torch.float32])
        torch.testing.assert_close(rstd, r_rstd, **TOL[torch.float32])
        got = norms.layer_norm_bwd(x, w, mu, rstd, g)
        for i, (a, e) in enumerate(zip(got, norms.layer_norm_bwd_ref(x, w, r_mu, r_rstd, g))):
            torch.testing.assert_close(a.float(), e.float(), **(tol if i == 0 else wtol))


@pytest.mark.parametrize("route,dtype,d", [("staged", torch.bfloat16, 25055),
                                           ("held", torch.bfloat16, 30011),
                                           ("held", torch.float32, 25055)])
@pytest.mark.parametrize("offset", [0, 1])
def test_layer_norm_wide_designs_match_plain(dev, route, dtype, d, offset):
    """Each entry point of the two routes for rows wider than the
    vectorised cap (csrc/norms.cu, LAYER_NORM_WIDE_DESIGN) against the
    plain version at a width ln_route gives it, at x's storage offset 0
    and 1; the other route's entry point refuses those rows."""
    from ps_slm_tpu_torch import _build

    n = 300
    assert norms.ln_route(d, dtype, ()) == route
    x, w, _ = _norm_inputs(dev, dtype, n, d, offset, 9)
    b = torch.zeros_like(w) - 0.5
    y = torch.empty(n, d, device=dev, dtype=dtype)
    mu, rstd = (torch.empty(n, 1, device=dev) for _ in range(2))
    lib = _build.load("norms", norms._SIGNATURES)
    args = (dev.index, _build.DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(),
            y.data_ptr(), mu.data_ptr(), rstd.data_ptr(), n, d, 1e-5, norms._blocks(x, n, 1),
            _build.stream_ptr(x))
    other = "held" if route == "staged" else "staged"
    assert getattr(lib, f"ps_layer_norm_fwd_{other}")(*args) != 0
    assert getattr(lib, f"ps_layer_norm_fwd_{route}")(*args) == 0
    torch.cuda.synchronize()
    r_y, r_mu, r_rstd = norms.layer_norm_ref(x, w, b)
    torch.testing.assert_close(y.float(), r_y.float(), **TOL[dtype])
    torch.testing.assert_close(mu, r_mu, **TOL[torch.float32])
    torch.testing.assert_close(rstd, r_rstd, **TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,offset", [(512, 0), (512, 1), (263, 0), (25055, 0), (25055, 1),
                                      (30011, 0)])
def test_layer_norm_fwd_is_deterministic(dev, dtype, d, offset):
    """Two calls give the same bits on every route (vec, general, staged,
    held): no atomics, every sum in a fixed order."""
    x, w, _ = _norm_inputs(dev, dtype, 2064, d, offset, 5)
    b = torch.zeros_like(w) + 0.25
    first = norms.layer_norm_fwd(x, w, b)
    second = norms.layer_norm_fwd(x, w, b)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


def _runs_of_frames(dev, b, t, v, seed):
    """A CTC posterior [B, T, V] whose argmax repeats in runs of 1 to 40
    frames, with blank (id 0) runs between them, and lengths [B]."""
    g_ = torch.Generator().manual_seed(seed)
    ids = torch.empty(b, t, dtype=torch.long)
    for r in range(b):
        pos = 0
        while pos < t:
            run = int(torch.randint(1, 41, (1,), generator=g_))
            ids[r, pos:pos + run] = int(torch.randint(0, v, (1,), generator=g_))
            pos += run
    logits = torch.randn(b, t, v, generator=g_)
    logits.scatter_add_(2, ids[..., None], torch.full((b, t, 1), 8.0))
    lens = torch.tensor([t - 13 * r for r in range(b)])
    return torch.softmax(logits, -1).to(dev), lens.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_psd_is_deterministic(dev, dtype):
    """Two PSD calls on the card give the same bits, with runs of up to 40
    repeated frames summed into one segment, and agree with the CPU."""
    from ps_slm_tpu_torch.ops.psd import psd

    post, lens = _runs_of_frames(dev, 4, 516, 2000, 0)
    feats = post.to(dtype)
    first = psd(feats, lens, feats)
    second = psd(feats, lens, feats)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    cpu = psd(feats.cpu(), lens.cpu(), feats.cpu())
    assert torch.equal(first[1].cpu(), cpu[1])
    torch.testing.assert_close(first[0].cpu().float(), cpu[0].float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_dkv_is_exactly_zero_outside_the_window(dev, dtype):
    """Keys outside a row's window, whole key tiles (0-63 and 192-199 of row
    0, every tile of the empty row 1) and the rest of partly covered tiles,
    get exact zeros."""
    starts, ends = [70, 0, 0], [130, 0, 200]
    args, kw = _bwd_inputs(dev, dtype, 3, 200, 12, 2, False, starts, ends)
    dk, dv = fa.flash_attention_dkv(*args, **kw)
    torch.cuda.synchronize()
    pos = torch.arange(200, device=dev)
    outside = ((pos[None] < torch.tensor(starts, device=dev)[:, None])
               | (pos[None] >= torch.tensor(ends, device=dev)[:, None]))
    assert outside[0, :64].all() and outside[0, 192:].all() and outside[1].all()
    assert not dk[outside].any() and not dv[outside].any()
    assert dk[~outside].abs().sum() > 0 and dv[~outside].abs().sum() > 0


def test_cuda_wrappers_give_gradients_equal_to_cpu(dev):
    """The repair: a loss through rms_norm, layer_norm and attention on CUDA
    tensors reaches every input, as on the CPU."""
    g_ = torch.Generator().manual_seed(0)
    b, s, hq, hkv, d = 2, 40, 4, 2, fa.HEAD_DIM
    leaves = {
        "x": torch.randn(b, s, hq * d, generator=g_),
        "w_rms": 1 + 0.1 * torch.randn(hq * d, generator=g_),
        "w_ln": 1 + 0.1 * torch.randn(hq * d, generator=g_),
        "b_ln": 0.1 * torch.randn(hq * d, generator=g_),
        "k": torch.randn(b, s, hkv, d, generator=g_),
        "v": torch.randn(b, s, hkv, d, generator=g_),
    }
    mask = torch.arange(s)[None] < torch.tensor([s, 29])[:, None]

    def grads(device):
        t = {n: x.to(device).requires_grad_(True) for n, x in leaves.items()}
        h = rms_norm(t["x"], t["w_rms"], 1e-6)
        h = layer_norm(h, t["w_ln"], t["b_ln"])
        out = attention(h.view(b, s, hq, d), t["k"], t["v"], mask.to(device), causal=True)
        loss = (out.float() ** 2).sum()
        loss.backward()
        return {n: x.grad for n, x in t.items()}

    def grads_f64():
        """The same loss in float64 by plain autograd: the reference.  The
        port's plain versions compute in fp32 whatever their inputs, and an
        fp32 CPU reference varied between processes by up to 1.3e-3."""
        t = {n: x.detach().double().requires_grad_(True) for n, x in leaves.items()}
        x = t["x"]
        h = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * t["w_rms"]
        h = torch.nn.functional.layer_norm(h, (hq * d,), t["w_ln"], t["b_ln"], 1e-5)
        q = h.view(b, s, hq, d).transpose(1, 2)                       # [B,Hq,S,D]
        k, v = (t[n].transpose(1, 2).repeat_interleave(hq // hkv, 1) for n in ("k", "v"))
        pos = torch.arange(s)
        pairs = mask[:, None, None, :] & (pos[None, :] <= pos[:, None])[None, None]
        scores = torch.where(pairs, (q @ k.transpose(-1, -2)) * d ** -0.5, float("-inf"))
        p = torch.where(pairs, torch.softmax(scores, -1), 0.0)
        ((p @ v) ** 2).sum().backward()
        return {n: x.grad for n, x in t.items()}

    n0 = (norms.rms_norm_bwd.launches, norms.layer_norm_bwd.launches,
          fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches)
    got = grads(dev)
    torch.cuda.synchronize()
    assert (norms.rms_norm_bwd.launches, norms.layer_norm_bwd.launches,
            fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches) == tuple(
                n + 1 for n in n0)
    for name, w in grads_f64().items():
        assert got[name] is not None, name
        torch.testing.assert_close(got[name].cpu().double(), w, atol=1e-4, rtol=1e-4)


def _posterior_rows(dev, dtype, kind, n=640, d=25055):
    """[n, d] rows the projector's LayerNorm sees in text-only TASU (5 x 128
    frames): smoothed one-hots ((1 - a) onehot + a / d, a in [0, 0.1)),
    clean one-hots, all-zero rows (pad frames, inactive insertions), or a
    batch of each utterance's smoothed frames followed by zero rows."""
    g_ = torch.Generator(device=dev).manual_seed(n)
    onehot = torch.nn.functional.one_hot(
        torch.randint(0, d, (n,), device=dev, generator=g_), d).float()
    alpha = 0.1 * torch.rand(n, 1, device=dev, generator=g_)
    smoothed = (1 - alpha) * onehot + alpha / d
    if kind == "mixed":
        valid = (torch.arange(n, device=dev) % 128) < torch.tensor(
            [128, 112, 96, 80, 64], device=dev).repeat_interleave(128)[:n]
        return (smoothed * valid[:, None]).to(dtype)
    return {"smoothed": smoothed, "clean": onehot, "zero": torch.zeros_like(onehot)}[kind].to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["smoothed", "clean", "zero", "mixed"])
def test_layer_norm_on_text_only_posterior_rows_matches_plain(dev, dtype, kind):
    """The projector's LayerNorm forward (staged in bf16, held in fp32) and
    backward at 640 x 25 055 on near-one-hot and all-zero rows, against
    their plain versions."""
    n, d = 640, 25055
    x = _posterior_rows(dev, dtype, kind, n, d)
    g_ = torch.Generator(device=dev).manual_seed(7)
    w = (1 + 0.1 * torch.randn(d, device=dev, generator=g_)).to(dtype)
    b = (0.1 * torch.randn(d, device=dev, generator=g_)).to(dtype)
    gy = torch.randn(n, d, device=dev, generator=g_).to(dtype)
    tol = TOL[dtype]
    before = dict(norms.layer_norm_fwd.routes)
    y, mu, rstd = norms.layer_norm_fwd(x, w, b)
    torch.cuda.synchronize()
    assert _route_moved(norms.layer_norm_fwd.routes, before) == [norms.ln_route(d, dtype, ())]
    r_y, r_mu, r_rstd = norms.layer_norm_ref(x, w, b)
    assert torch.isfinite(y.float()).all()
    torch.testing.assert_close(y.float(), r_y.float(), **tol)
    torch.testing.assert_close(mu, r_mu, **TOL[torch.float32])
    torch.testing.assert_close(rstd, r_rstd, **TOL[torch.float32])
    got = norms.layer_norm_bwd(x, w, mu, rstd, gy)
    torch.cuda.synchronize()
    want = norms.layer_norm_bwd_ref(x, w, r_mu, r_rstd, gy)
    for i, (a, e) in enumerate(zip(got, want)):
        torch.testing.assert_close(a.float(), e.float(),
                                   **(tol if i == 0 else dict(tol, atol=tol["atol"] * n ** 0.5)))


@pytest.mark.parametrize("width,k", [(24, 8), (151936, 4), (4 * 151936, 8)])
def test_beam_top_k_tie_order_on_card(dev, width, k):
    """The beam's top-k on the card on rows full of ties: values descending,
    the lower index first among equal values (as jax.lax.top_k), which a
    stable sort on the CPU gives."""
    from ps_slm_tpu_torch.inference import generate as gen

    x = torch.randint(0, 4, (4, width), generator=torch.Generator().manual_seed(width)).float()
    want_v, want_i = (t[..., :k] for t in torch.sort(x, dim=-1, descending=True, stable=True))
    got_v, got_i = (gen.top_k if width < 100 else gen.top_k_wide)(x.to(dev), k)
    assert torch.equal(got_v.cpu(), want_v) and torch.equal(got_i.cpu(), want_i)


def test_beam_generate_is_bit_identical_on_card(dev):
    """Two beam-4 decodes of a small bf16 Qwen2 (head dim 128, a head with
    duplicated rows for exact ties) give the same tokens."""
    from ps_slm_tpu_torch.inference.generate import beam_generate
    from ps_slm_tpu_torch.models.qwen2 import Qwen2Config, Qwen2Model

    cfg = Qwen2Config.tiny(vocab_size=1000, hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2, head_dim=128, num_hidden_layers=2)
    llm = Qwen2Model(cfg)
    llm.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        llm.embed_tokens.weight[500:] = llm.embed_tokens.weight[:500]
    llm = llm.to(dev, torch.bfloat16)
    g_ = torch.Generator().manual_seed(1)
    emb = torch.randn(3, 40, 256, generator=g_).to(dev, torch.bfloat16)
    mask = torch.ones(3, 40, dtype=torch.bool)
    mask[1, :7], mask[2, :30] = False, False
    pos = (mask.long().cumsum(1) - 1).clamp(min=0)
    runs = [beam_generate(llm, emb, mask.to(dev), pos.to(dev), max_new_tokens=12,
                          eos_token_id=7, num_beams=4) for _ in range(2)]
    torch.cuda.synchronize()
    assert runs[0].shape == (3, 12) and bool(((runs[0] >= 0) & (runs[0] < 1000)).all())
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("do_sample,temperature,top_p,min_length,penalty", [
    (False, 1.0, 1.0, 1, 1.0), (False, 1.0, 1.0, 3, 1.3), (True, 1.0, 1.0, 1, 1.0),
    (True, 0.7, 1.0, 1, 1.0), (True, 1.0, 0.9, 1, 1.0), (True, 0.8, 0.5, 3, 1.3),
])
def test_sample_from_on_card_matches_cpu(dev, do_sample, temperature, top_p, min_length, penalty):
    """``sample_from`` on the card (its sort, softmax, cumsum and gather of
    the top-p cutoff) gives the CPU's tokens on the same logits and the same
    Gumbel noise, over the full Qwen2.5 vocabulary."""
    from ps_slm_tpu_torch.inference.generate import gumbel_noise, sample_from

    b, v, eos = 8, 151936, 151645
    g_ = torch.Generator().manual_seed(v + min_length)
    logits = 3 * torch.randn(b, v, generator=g_)
    logits[:, eos] += 12.0          # EOS the greedy pick, unless min_length masks it
    seen = torch.rand(b, v, generator=g_) < 0.01
    noise = gumbel_noise((b, v), g_)
    kw = dict(eos_token_id=eos, do_sample=do_sample, temperature=temperature, top_p=top_p,
              min_length=min_length, repetition_penalty=penalty)
    for t in (0, 4):
        want = sample_from(logits, t, seen, noise, **kw)
        got = sample_from(logits.to(dev), t, seen.to(dev), noise.to(dev), **kw)
        assert torch.equal(got.cpu(), want)


def test_generate_samples_on_card_with_a_card_generator(dev):
    """TASU ``generate(num_beams=1, do_sample=True)`` on a small text-only
    model (head dim 128) with a ``torch.Generator`` on the card as ``key``:
    valid tokens, the same on two calls with the same seed."""
    from ps_slm_tpu_torch.config import text_only_configs
    from ps_slm_tpu_torch.inference.generate import generate
    from ps_slm_tpu_torch.models.tasu import model_factory

    tc, mc = text_only_configs(
        dict(num_blocks=1, tp_blocks=1, input_size=24, output_size=16, attention_heads=2,
             linear_units=32, vocab_size=600),
        dict(vocab_size=1000, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=128))
    model = model_factory(tc, mc, device=dev)
    model.speech_token_id = 998
    g_ = torch.Generator().manual_seed(0)
    ids = torch.randint(1, 900, (3, 8), generator=g_)
    ids[:, 3] = 998
    batch = {"input_ids": ids, "attention_mask": torch.ones(3, 8, dtype=torch.bool),
             "gt_ids": torch.randint(1, 600, (3, 20), generator=g_),
             "gt_lens": torch.tensor([20, 13, 5])}
    kw = dict(eos_token_id=7, num_beams=1, do_sample=True, temperature=0.8, top_p=0.9,
              min_length=3, repetition_penalty=1.3, max_new_tokens=12, device=dev)
    runs = [generate(model, batch, key=torch.Generator(device=dev).manual_seed(5), **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert runs[0].shape == (3, 12) and bool(((runs[0] >= 0) & (runs[0] < 1000)).all())
    assert not bool((runs[0][:, :2] == 7).any())       # min_length 3
    assert torch.equal(runs[0], runs[1])


def test_frontend_on_card_matches_cpu(dev):
    """The waveform front end (fbank in float64, LFR, CMVN) on the card
    gives the CPU's features on int16 waveforms, ragged, with a row
    shorter than one frame: lengths equal, values within 1e-3."""
    from ps_slm_tpu_torch.ops.fbank import frontend

    g_ = torch.Generator().manual_seed(0)
    lens = torch.tensor([48000, 31234, 16001, 300])
    w = (torch.randn(4, 48000, generator=g_) * 3000).round().clamp(-32768, 32767)
    w = torch.where(torch.arange(48000)[None] < lens[:, None], w, 0).to(torch.int16)
    cmvn = (-(12 + torch.randn(560, generator=g_)), 0.25 + 0.05 * torch.rand(560, generator=g_))
    want, wlen = frontend(w, lens, cmvn=cmvn)
    got, glen = frontend(w.to(dev), lens.to(dev), cmvn=tuple(c.to(dev) for c in cmvn))
    torch.cuda.synchronize()
    assert torch.equal(glen.cpu(), wlen) and wlen.tolist()[-1] == 0
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=0)


def test_decode_cli_on_card_matches_cpu(dev, tmp_path):
    """``cli.decode.main`` on the card and on the CPU, fp32, beam 4, on
    scripts/decode.sh's asset layout (chip_smoke.py's writers) at small
    widths with head dim 128: the ``_pred`` files are byte-identical."""
    import chip_smoke
    from ps_slm_tpu_torch.cli import decode
    from ps_slm_tpu_torch.config import ModelConfig, TrainConfig
    from ps_slm_tpu_torch.models.tasu import model_factory

    llm = dict(vocab_size=1000, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=128)
    enc = dict(input_size=560, output_size=256, attention_heads=2, linear_units=512,
               num_blocks=2, tp_blocks=1, vocab_size=600)
    model = model_factory(TrainConfig(ctc_posterior=True, do_psd=True, seed=3), ModelConfig(
        llm_dim=256, encoder_dim=600, llm_config_overrides=llm, encoder_config_overrides=enc),
        device="cpu")
    assets = chip_smoke.write_assets(
        str(tmp_path), model, llm_dtype=torch.float32,
        specials={"<|endoftext|>": 900, "<|im_start|>": 901, "<|im_end|>": 902},
        utts={"ark": 3, "wav": 1, "flac": 1}, seconds=(0.5, 1.5))
    files = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        log = str(tmp_path / name / "test")
        args = chip_smoke.decode_args(assets, log, 8, llm_dim=256, encoder_dim=600)
        assert decode.main(args + ["++train_config.mixed_precision=false"], device=device) == 0
        with open(log + "_pred", "rb") as f:
            files[name] = f.read()
    assert files["card"] == files["cpu"] and files["card"].count(b"\n") == 5


def _small_audio_model(dev, dtype=torch.float32, **train):
    """A small audio-TASU model on the card (head dim 128, 560-wide input),
    its LLM trainable so the backward runs through every LLM kernel."""
    from ps_slm_tpu_torch.config import ModelConfig, TrainConfig
    from ps_slm_tpu_torch.models.tasu import model_factory

    llm = dict(vocab_size=1000, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=128)
    enc = dict(input_size=560, output_size=256, attention_heads=2, linear_units=512,
               num_blocks=2, tp_blocks=1, vocab_size=600)
    tc = TrainConfig(ctc_posterior=True, do_psd=True, freeze_encoder=True, seed=3,
                     mixed_precision=dtype == torch.bfloat16, **train)
    model = model_factory(tc, ModelConfig(llm_dim=256, encoder_dim=600, llm_config_overrides=llm,
                                          encoder_config_overrides=enc), device=dev, dtype=dtype)
    model.speech_token_id = 998
    return tc, model


def _waveform_batch(n=3, samples=16000, seed=0):
    g_ = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, 900, (n, 12), generator=g_)
    ids[:, 3] = 998
    labels = ids.clone()
    labels[:, :4] = -100
    lens = torch.tensor([samples, samples - 3000, samples // 3, samples - 7000][:n])
    w = (torch.randn(n, samples, generator=g_) * 3000).round().clamp(-32768, 32767)
    w = torch.where(torch.arange(samples)[None] < lens[:, None], w, 0).to(torch.int16)
    return {"input_ids": ids, "attention_mask": torch.ones(n, 12, dtype=torch.bool),
            "labels": labels, "waveform": w, "waveform_length": lens}


def test_frontend_training_draws_on_card(dev):
    """``frontend(train=True)`` with a generator on the card draws on the
    card: dither noise [B, T, 400] fp32, widths in [0, w], time starts in
    each row's valid LFR frames; the CPU front end fed the same draws gives
    the same masks and features within 1e-3."""
    from ps_slm_tpu_torch.config import FbankConfig
    from ps_slm_tpu_torch.ops import fbank as fb

    cfg = FbankConfig(specaug=True, specaug_t_width=5)
    batch = _waveform_batch()
    w, lens = batch["waveform"].to(dev), batch["waveform_length"].to(dev)
    draws = fb.frontend_draws(w, lens, torch.Generator(device=dev).manual_seed(0), cfg)
    assert all(t.device.type == "cuda" for t in draws)
    assert draws.dither.shape == (3, 98, 400) and draws.dither.dtype == torch.float32
    lfr = [-(-max(1 + (int(n) - 400) // 160, 0) // 6) for n in batch["waveform_length"]]
    for row, n in enumerate(lfr):
        assert bool((draws.t_starts[row] < max(n, 1)).all())
    assert bool((draws.t_widths <= 5).all() & (draws.f_widths <= 10).all() & (draws.f_starts < 560).all())
    got, glen = fb.frontend(w, lens, cfg=cfg, train=True, draws=draws)
    want, wlen = fb.frontend(batch["waveform"], batch["waveform_length"], cfg=cfg, train=True,
                             draws=fb.FrontendDraws(*(t.cpu() for t in draws)))
    torch.cuda.synchronize()
    assert torch.equal(glen.cpu(), wlen)
    assert torch.equal(got.cpu() == 0, want == 0) and bool((want == 0).any())
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=0)


def test_device_prefetch_copy_equals_host_batch_under_busy_stream(dev):
    """The producer thread's pinned, non-blocking copies on a side stream,
    made while the consumer's stream is busy with large products, arrive
    equal to the host batches, in order."""
    import numpy as np

    from ps_slm_tpu_torch.data.prefetch import device_prefetch

    rng = np.random.default_rng(0)
    host = [{"x": rng.normal(size=(256, 1024)).astype(np.float32),
             "ids": rng.integers(0, 100, size=(64,)), "key": f"b{i}"} for i in range(8)]
    a = torch.randn(4096, 4096, device=dev)
    seen = []
    for h, d in device_prefetch(iter(host), dev, lambda b: {"x": b["x"], "ids": b["ids"]}):
        for _ in range(4):
            a = torch.tanh(a @ a * 1e-3)          # keeps the consumer's stream busy
        seen.append((h["key"], d["x"].sum() - float(h["x"].sum()), d["ids"].cpu()))
    torch.cuda.synchronize()
    assert [k for k, _, _ in seen] == [f"b{i}" for i in range(8)]
    for (_, diff, ids), h in zip(seen, host):
        assert abs(float(diff)) < 1e-2 and torch.equal(ids, torch.from_numpy(h["ids"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_is_bit_identical_on_card(dev, dtype):
    """A training forward and backward with remat on and off: the same
    loss and projector gradients bit for bit; remat adds one flash forward
    a layer and two RMSNorm forwards a layer (the recomputed blocks)."""
    from ps_slm_tpu_torch.models import tasu

    batch = {k: v.to(dev) for k, v in _waveform_batch().items()}
    out, launches = {}, {}
    for remat in (False, True):
        tc, model = _small_audio_model(dev, dtype)
        model.remat = remat
        tasu.trainable_mask(model, tc)
        f0, r0 = fa.flash_attention_fwd.launches, norms.rms_norm_fwd.launches
        loss, _ = tasu.forward(model, batch, generator=torch.Generator(device=dev).manual_seed(1))
        loss.backward()
        torch.cuda.synchronize()
        launches[remat] = (fa.flash_attention_fwd.launches - f0, norms.rms_norm_fwd.launches - r0)
        out[remat] = (loss.detach(), [p.grad.clone() for n, p in model.named_parameters()
                                      if n.startswith("projector.")])
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(a, b) for a, b in zip(out[False][1], out[True][1]))
    assert launches[True] == (launches[False][0] + 2, launches[False][1] + 4)


def test_train_state_round_trip_on_card(dev, tmp_path):
    """Two steps, save, two more; a fresh step restored from the save
    makes the same two steps bit for bit (the card generator's state, which
    draws the dither and the masks, included)."""
    from ps_slm_tpu_torch.config import FbankConfig
    from ps_slm_tpu_torch.training import checkpoint as ckpt
    from ps_slm_tpu_torch.training.step import make_train_step

    batch = _waveform_batch()
    runs = []
    for restore in (False, True):
        tc, model = _small_audio_model(dev, gradient_accumulation_steps=2, lr=1e-3,
                                       warmup_steps=1)
        model.fbank_cfg = FbankConfig(specaug=True)
        step = make_train_step(model, tc, device=dev)
        if restore:
            ckpt.restore_train_state(str(tmp_path / "s"), step)
        else:
            for _ in range(3):
                step(batch)
            ckpt.save_train_state(str(tmp_path / "s"), step)
        losses = [float(step(batch)["loss"]) for _ in range(2)]
        runs.append((losses, [p.detach().clone() for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


@pytest.mark.parametrize("what", ["q8", "q4", "kv"])
def test_quantization_on_card_equals_cpu(dev, what):
    """Weight codes and scales (as the JAX package's eager factory divides)
    and KV codes and scales (as its jitted forward multiplies) are the same
    bits on the card as on the CPU."""
    from ps_slm_tpu_torch.models import quantization as q

    g = torch.Generator().manual_seed(0)
    if what == "kv":
        x = torch.randn(64, 32, 2, 128, generator=g) * 3
        got, want = q.quantize_kv(x.to(dev)), q.quantize_kv(x)
    else:
        w = torch.randn(2, 1536, 896, generator=g) * 0.02
        fn = q.quantize_kernel if what == "q8" else q.quantize_kernel4
        got, want = fn(w.to(dev)), fn(w)
        got, want = [got[k] for k in sorted(got)], [want[k] for k in sorted(want)]
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


POOL_PREFILL, POOL_MAX_NEW = 24, 20


def _pool_llm(dev):
    """A small int8-weight bf16 Qwen2 (head dim 128), as the serving cell's
    LLM is quantized."""
    from ps_slm_tpu_torch.models.qwen2 import Qwen2Config, Qwen2Model
    from ps_slm_tpu_torch.models.quantization import quantize_llm

    cfg = Qwen2Config.tiny(vocab_size=1000, hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2, head_dim=128, num_hidden_layers=2)
    llm = Qwen2Model(cfg)
    llm.init_weights(torch.Generator().manual_seed(0))
    return quantize_llm(llm.to(dev, torch.bfloat16), 8).eval()


def _pool_requests(dev, n=11):
    """Ragged merged prefills, left-padded to the bucket by the pool."""
    from types import SimpleNamespace

    g = torch.Generator().manual_seed(1)
    reqs = {}
    for i in range(n):
        s = int(torch.randint(5, POOL_PREFILL + 1, (1,), generator=g))
        reqs[f"r{i}"] = SimpleNamespace(
            embeds=torch.randn(1, s, 256, generator=g).to(dev, torch.bfloat16),
            attention_mask=torch.ones(1, s, dtype=torch.bool, device=dev),
            position_ids=torch.arange(s, device=dev)[None])
    return reqs


def _greedy_pool(llm, reqs, eos, kv_bits, dev):
    from types import SimpleNamespace

    from ps_slm_tpu_torch.inference.continuous import ContinuousGreedyDecoder

    return ContinuousGreedyDecoder(
        SimpleNamespace(llm=llm), merge=lambda batch: reqs[batch["key"]], num_slots=4,
        prefill_len=POOL_PREFILL, max_new_tokens=POOL_MAX_NEW, eos_token_id=eos, sync_every=3,
        kv_bits=kv_bits, device=dev)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_captured_greedy_pool_equals_eager_on_card(dev, kv_bits):
    """The greedy pool's chunk as a CUDA graph: right after construction
    the pool's masks, offsets, positions, counts and tokens are
    ``_init_pool``'s (the cache differs in cell 0 alone); over a backlog
    with ragged caps, an EOS some requests emit and refills between chunks,
    the captured pool gives the same tokens, bit for bit, as the same pool
    stepped eagerly through ``_pool_steps``; the pool captures once and
    every chunk is a replay."""
    from ps_slm_tpu_torch.inference.continuous import _init_pool
    from ps_slm_tpu_torch.utils import profiler

    llm, reqs = _pool_llm(dev), _pool_requests(dev)
    g = torch.Generator().manual_seed(2)
    caps = {k: int(torch.randint(1, POOL_MAX_NEW + 1, (1,), generator=g)) for k in reqs}
    caps["r0"] = POOL_MAX_NEW

    def run(dec, stop_after=None):
        return dict(dec.run(((k, {"key": k}) for k in reqs), stop_after=stop_after))

    probe = _greedy_pool(llm, reqs, 999, kv_bits, dev)
    fresh = _init_pool(llm, 4, POOL_PREFILL + POOL_MAX_NEW, 3, 999, torch.bfloat16,
                       kv_bits, dev)
    assert probe.graph is not None
    for name, v in vars(fresh).items():
        if name != "cache":
            assert torch.equal(getattr(probe.pool, name), v), name
    for layer, layer0 in zip(probe.pool.cache, fresh.cache):
        for leaf, leaf0 in zip(layer, layer0):
            assert torch.equal(leaf[:, 1:], leaf0[:, 1:])
    eos = int(run(probe)["r0"][4])                  # r0 ends at it, before its cap
    eager = _greedy_pool(llm, reqs, eos, kv_bits, dev)
    eager.graph = None
    want = run(eager, caps)
    before = profiler.counts()
    captured = _greedy_pool(llm, reqs, eos, kv_bits, dev)
    got = run(captured, caps)
    change = {k: v - before.get(k, 0) for k, v in profiler.counts().items()}
    assert set(got) == set(want) == set(reqs)
    for key in want:
        assert got[key].tolist() == want[key].tolist(), key
    assert len(want["r0"]) <= 4 and len({len(v) for v in want.values()}) > 2
    assert change["pool.graph_captures"] == 1
    assert change["pool.graph_replays"] == change["pool.chunks"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,eps", [(832, 560, 1e-5), (832, 512, 1e-5), (256, 768, 1e-12),
                                     (256, 1536, 1e-5)])
def test_layer_norm_at_encoder_training_and_qformer_shapes(dev, dtype, n, d, eps):
    g_ = torch.Generator(device=dev).manual_seed(n + d)
    x = (torch.randn(n, d, device=dev, generator=g_) * 3 + 1).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device=dev, generator=g_)).to(dtype)
    b = (0.1 * torch.randn(d, device=dev, generator=g_)).to(dtype)
    g = torch.randn(n, d, device=dev, generator=g_).to(dtype)
    tol = TOL[dtype]
    for a, e in zip(norms.layer_norm_fwd(x, w, b, eps), norms.layer_norm_ref(x, w, b, eps)):
        torch.testing.assert_close(a.float(), e.float(), **tol)
    _, mu, rstd = norms.layer_norm_ref(x, w, b, eps)
    wtol = dict(tol, atol=tol["atol"] * n ** 0.5)
    got = norms.layer_norm_bwd(x, w, mu, rstd, g)
    for i, (a, e) in enumerate(zip(got, norms.layer_norm_bwd_ref(x, w, mu, rstd, g))):
        torch.testing.assert_close(a.float(), e.float(), **(tol if i == 0 else wtol))


def test_ctc_on_card_matches_cpu_and_is_deterministic(dev):
    from ps_slm_tpu_torch.ops import ctc

    g = torch.Generator().manual_seed(0)
    b, t, v, n = 6, 60, 25055, 20
    logits = torch.randn(b, t, v, generator=g) * 3
    lens = torch.tensor([60, 51, 40, 33, 60, 9])
    labels = torch.randint(1, v, (b, n), generator=g)
    labels[:, 5] = labels[:, 4]                     # repeats
    label_lens = torch.tensor([20, 15, 12, 10, 20, 14])    # the last row infeasible
    want = ctc._ctc_nll(logits, lens, labels, label_lens, 0)
    grads = []
    for _ in range(2):
        x = logits.to(dev).requires_grad_(True)
        got = ctc._ctc_nll(x, lens.to(dev), labels.to(dev), label_lens.to(dev), 0)
        got.mean().backward()
        grads.append(x.grad)
    torch.testing.assert_close(got.detach().cpu(), want, atol=1e-5, rtol=1e-5)
    assert torch.equal(grads[0], grads[1])
    lp = torch.log_softmax(logits, -1)
    tgt_lens = torch.minimum(label_lens, lens // 2)
    a_cpu = ctc.ctc_forced_align(lp, labels, lens, tgt_lens)
    a_gpu = ctc.ctc_forced_align(lp.to(dev), labels.to(dev), lens.to(dev), tgt_lens.to(dev))
    assert torch.equal(a_gpu.cpu(), a_cpu)
    ids_c, n_c = ctc.ctc_greedy_decode(lp, lens)
    ids_g, n_g = ctc.ctc_greedy_decode(lp.to(dev), lens.to(dev))
    assert torch.equal(ids_g.cpu(), ids_c) and torch.equal(n_g.cpu(), n_c)


@pytest.mark.parametrize("name", ["q-former", "cross-attention", "cov1d-linear"])
def test_projectors_on_card_match_cpu(dev, name):
    """Each projector's forward and gradients through the card's kernels
    (the q-former's LayerNorms take an expanded, strided query) equal the
    CPU's at fp32 1e-4."""
    from ps_slm_tpu_torch.config import ModelConfig
    from ps_slm_tpu_torch.models import projector as proj

    cfg = ModelConfig(encoder_projector=name, encoder_dim=40, llm_dim=256, qformer_layers=2,
                      qformer_heads=4, query_len=8, ca_heads=2, encoder_projector_ds_rate=2)
    g = torch.Generator().manual_seed(0)
    cpu = proj.build_projector(cfg)
    cpu.init_weights(g)
    card = proj.build_projector(cfg).to(dev)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 21, 40, generator=g)
    extra = (torch.randn(500, 256, generator=g),) if name == "cross-attention" else ()
    outs = []
    for m, d in ((cpu, "cpu"), (card, dev)):
        out = m(x.to(d), *(e.to(d) for e in extra), **({"chunk": 128} if extra else {}))
        out.square().sum().backward()
        outs.append((out.detach().cpu(), {n: p.grad.cpu() for n, p in m.named_parameters()}))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-4, rtol=1e-4)
    for n, grad in outs[0][1].items():
        torch.testing.assert_close(outs[1][1][n], grad, atol=1e-4, rtol=1e-4)


def _parallel_steps(dev, mesh_shape=None):
    """Two dithered training steps of the small audio model, its projector
    and its LLM trained (the encoder frozen), on a 4-row batch, on
    ``mesh_shape`` (this process's block of the rows) or in one process;
    the losses, the trained parameters and AdamW's first moments after the
    second step, gathered."""
    from ps_slm_tpu_torch.config import FbankConfig
    from ps_slm_tpu_torch.models import tasu
    from ps_slm_tpu_torch.parallel import mesh as meshlib
    from ps_slm_tpu_torch.training.step import make_train_step

    tc, model = _small_audio_model(dev, lr=PARALLEL_LR, warmup_steps=1, freeze_llm=False)
    model.fbank_cfg = FbankConfig(dither=1.0)
    batch = _waveform_batch(n=4)
    if mesh_shape:
        tasu.trainable_mask(model, tc)
        meshlib.shard_params(model, meshlib.build_mesh(mesh_shape, "cuda"), mesh_shape, 1)
        block = model.mesh.row_block
        n = 4 // block.count
        batch = {k: v[block.index * n:(block.index + 1) * n] for k, v in batch.items()}
    step = make_train_step(model, tc, device=dev)
    losses = [float(step(batch)["loss"]) for _ in range(2)]
    params = dict(model.named_parameters())
    moments = {}
    for n in step.trainable:
        m = step.optimizer.state[params[n]]["exp_avg"]
        moments[n] = (model.mesh.whole(n, m) if mesh_shape else m).detach().cpu()
    with meshlib.gathered(model) if mesh_shape else _nullcontext():
        trained = {n: p.detach().cpu().clone() for n, p in model.named_parameters()
                   if n in step.trainable}
    return losses, trained, moments


class _nullcontext:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


PARALLEL_LR = 1e-3
PARALLEL_MOMENT_TOL = 1e-5   # of each trained tensor's largest first moment
GRAD_FLOOR = 1e-3            # of a tensor's largest moment: below it, AdamW's direction is rounding


def test_two_processes_on_one_card_equal_one(dev, tmp_path):
    """Two processes share cuda:0 over gloo on a ``{"data": 2}`` mesh and
    train the projector and the LLM: both report the same global losses
    bit for bit, and against one process on the card the losses are
    within 1e-5 and AdamW's first moments after the second step (the
    first at the warm-up's lr 0, so both gradients are taken at the
    initial weights) within 1e-5 of each tensor's largest, which a
    gradient scaled by a constant fails.  The trained weights are
    within 1e-5 wherever the one-process moment is at least GRAD_FLOOR of
    its tensor's largest; below it AdamW's m / (sqrt(v) + eps) takes its
    direction from rounding (the ranks' GEMMs sum in another order), so
    those elements are held to the one update's reach, 2.1 lr.  The dither
    is drawn at the global batch's shape from the same generator."""
    import json
    import os
    import sys

    from ps_slm_tpu_torch.parallel.launch import launch

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = launch([sys.executable, os.path.abspath(__file__), str(tmp_path)], 2,
                  env={"PS_DIST_BACKEND": "gloo", "PYTHONPATH": root}, timeout=300, cwd=root)
    for f in done:
        assert f.returncode == 0, f"rank {f.rank}\n{f.stdout[-2000:]}\n{f.stderr[-4000:]}"
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True) for r in range(2)]
    want_losses, want, want_mom = _parallel_steps(dev)
    assert ranks[0]["losses"] == ranks[1]["losses"], json.dumps([r["losses"] for r in ranks])
    torch.testing.assert_close(torch.tensor(ranks[0]["losses"]), torch.tensor(want_losses),
                               atol=1e-5, rtol=1e-5)
    assert any(n.startswith("projector.") for n in want) and any(
        n.startswith("llm.layers.") for n in want)
    got, got_mom = ranks[0]["params"], ranks[0]["moments"]
    assert sorted(got_mom) == sorted(want_mom)
    mom_err = {n: float((got_mom[n] - m).abs().max()) / float(m.abs().max())
               for n, m in want_mom.items()}
    kept_err, floored_err = {}, {}
    for n, w in want.items():
        d = (got[n] - w).abs()
        m = want_mom[n].abs()
        big = m >= GRAD_FLOOR * m.max()
        kept_err[n] = float(d[big].max())
        floored_err[n] = float(d[~big].max()) if not bool(big.all()) else 0.0
    worst = {what: sorted(errs.items(), key=lambda x: -x[1])[:4] for what, errs in (
        ("moments", mom_err), ("kept", kept_err), ("floored", floored_err))}
    assert max(mom_err.values()) <= PARALLEL_MOMENT_TOL, worst
    assert max(kept_err.values()) <= 1e-5, worst
    # the rest: two updates of opposite sign, each at most lr (and AdamW's
    # bias-corrected m / sqrt(v) after two steps at most 1.0015)
    assert max(floored_err.values()) <= 2.1 * PARALLEL_LR, worst


def test_whisper_log_mel_on_card_equals_cpu(dev):
    """The whisper front end on the card against the CPU, fp32 both: within
    1e-4 after the (x + 4) / 4 scaling."""
    from ps_slm_tpu_torch.ops.fbank import pad_or_trim, whisper_log_mel

    g_ = torch.Generator().manual_seed(0)
    wav = torch.stack([pad_or_trim(0.1 * torch.randn(16000 * s, generator=g_)) for s in (3, 30)])
    want = whisper_log_mel(wav)
    got = whisper_log_mel(wav.to(dev))
    assert got.device.type == "cuda" and got.shape == want.shape == (2, 128, 3000)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


if __name__ == "__main__":
    # one rank of test_two_processes_on_one_card_equal_one
    import os
    import sys

    from ps_slm_tpu_torch.parallel.mesh import init_distributed

    world, rank = init_distributed("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        losses, params, moments = _parallel_steps(
            torch.device("cuda", torch.cuda.current_device()), {"data": 2})
        torch.save({"losses": losses, "params": params, "moments": moments},
                   os.path.join(sys.argv[1], f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


# Latent attention's expanded prefill (q/k 192, v 128): a pool prefill's
# shapes (rows left-padded to 2 000, 16 heads), and the 64-row tiles' edges
# (S of 1 and 65, a window that starts mid-tile, a row with no valid key)
MLA_CASES = {
    "pool_prefill": (2, 2000, 16, [1700, 1937], [2000, 2000]),
    "s65_mid_window": (3, 65, 16, [0, 5, 64], [65, 65, 64]),
    "s1": (2, 1, 16, [0, 0], [1, 1]),
}


@pytest.mark.parametrize("case", sorted(MLA_CASES))
def test_flash_mla_kernel_matches_plain(dev, case):
    """The 192/128 instantiation against the plain version (bf16 tolerance);
    it counts its own launches and leaves the 128 route's count alone."""
    b, s, h, starts, ends = MLA_CASES[case]
    g = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn(b, s, h, 192, device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn(b, s, h, 192, device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn(b, s, h, 128, device=dev, generator=g).to(torch.bfloat16)
    pos = torch.arange(s, device=dev)
    mask = ((pos[None] >= torch.tensor(starts, device=dev)[:, None])
            & (pos[None] < torch.tensor(ends, device=dev)[:, None]))
    start, end = fa.window_from_mask(mask, b, s, dev)
    n0, m0 = fa.flash_attention_fwd.launches, fa.flash_attention_fwd.mla_launches
    out, lse = fa.flash_attention_fwd(q, k, v, start, end, causal=True, scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.mla_launches == m0 + 1
    assert fa.flash_attention_fwd.launches == n0
    ref_out, ref_lse = fa.flash_attention_ref(q, k, v, start, end, causal=True,
                                              scale=192 ** -0.5)
    assert out.shape == (b, s, h, 128) and not torch.isnan(out).any()
    torch.testing.assert_close(out.float(), ref_out.float(), **TOL[torch.bfloat16])
    torch.testing.assert_close(lse, ref_lse, **TOL[torch.float32])


def test_flash_mla_backward_refuses_on_card(dev):
    q = torch.zeros(1, 4, 2, 192, device=dev, dtype=torch.bfloat16, requires_grad=True)
    v = torch.zeros(1, 4, 2, 128, device=dev, dtype=torch.bfloat16)
    out = fa.flash_attention(q, q.detach(), v, causal=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        out.sum().backward()


@pytest.mark.parametrize("tokens", [64, 4000])
def test_moe_grouped_kernels_match_plain(dev, tokens):
    """The grouped expert kernels at Moonlight's widths (H 2048, I 1408, 64
    experts, 6 a token) against the plain per-expert loop in fp32 from the
    same bf16 inputs: a decode step's 64 rows, and a prefill whose first
    3 000 rows are alike (left padding), so a few experts take most pairs.
    Tolerance 2e-2: the intermediate is rounded to bf16 once, the output
    once.  Two calls give the same bits (no atomics)."""
    from ps_slm_tpu_torch.ops import moe

    g = torch.Generator(device=dev).manual_seed(tokens)
    h, i, e, k = 2048, 1408, 64, 6
    gate_up = (torch.randn(e, 2 * i, h, device=dev, generator=g) * h ** -0.5).to(torch.bfloat16)
    down = (torch.randn(e, h, i, device=dev, generator=g) * i ** -0.5).to(torch.bfloat16)
    x = torch.randn(tokens, h, device=dev, generator=g).to(torch.bfloat16)
    if tokens > 64:
        x[:3000] = x[0]
    gate = torch.randn(e, h, device=dev, generator=g) * h ** -0.5
    idx, w = moe.route(x, gate, torch.zeros(e, device=dev), k, 2.446)
    counts = moe.record(idx, e, 0, 1, step=tokens == 64)
    n0 = moe.experts.launches
    got = moe.experts(x, idx, w, gate_up, down, counts)
    again = moe.experts(x, idx, w, gate_up, down, counts)
    torch.cuda.synchronize()
    assert moe.experts.launches == n0 + 4
    assert torch.equal(got, again)
    want = moe.experts_ref(x.float(), idx, w, gate_up.float(), down.float())
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)


def test_moe_grouped_kernels_at_ragged_widths(dev):
    """Widths that are no multiple of a block (H 136, I 72: a partial depth
    stage and partial column blocks) and an expert no row chose, on both
    block shapes, against the plain per-expert loop."""
    from ps_slm_tpu_torch.ops import moe

    g = torch.Generator(device=dev).manual_seed(7)
    h, i, e, k = 136, 72, 8, 3
    gate_up = (torch.randn(e, 2 * i, h, device=dev, generator=g) * h ** -0.5).to(torch.bfloat16)
    down = (torch.randn(e, h, i, device=dev, generator=g) * i ** -0.5).to(torch.bfloat16)
    for tokens in (5, 300):
        x = torch.randn(tokens, h, device=dev, generator=g).to(torch.bfloat16)
        gate = torch.randn(e, h, device=dev, generator=g) * h ** -0.5
        bias = torch.zeros(e, device=dev)
        bias[3] = -100.0                     # expert 3 is never chosen
        idx, w = moe.route(x, gate, bias, k, 2.446)
        counts = moe.record(idx, e, 0, 1, step=False)
        got = moe.experts(x, idx, w, gate_up, down, counts)
        want = moe.experts_ref(x.float(), idx, w, gate_up.float(), down.float())
        torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)


def _moe_llm(dev):
    """A small bf16 DeepSeek-V3 at the kernels' head dims (q/k 192, v 128)."""
    from ps_slm_tpu_torch.models import deepseek_v3 as ds

    cfg = ds.DeepseekV3Config.tiny(vocab_size=1000, hidden_size=256, intermediate_size=512,
                                   moe_intermediate_size=128, num_hidden_layers=3,
                                   num_attention_heads=2, n_routed_experts=8,
                                   n_shared_experts=1, num_experts_per_tok=3, kv_lora_rank=64,
                                   qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128)
    llm = ds.DeepseekV3Model(cfg)
    llm.init_weights(torch.Generator().manual_seed(0))
    return llm.to(dev, torch.bfloat16).eval()


def test_captured_moe_pool_equals_eager_on_card(dev):
    """The greedy pool on a DeepSeek-V3 decoder: its chunk (absorbed latent
    attention, routing and the grouped kernels) is captured as one CUDA
    graph and gives the eager chunk's tokens bit for bit; each replay adds
    its rows to the device tallies."""
    from ps_slm_tpu_torch.utils import profiler

    llm, reqs = _moe_llm(dev), _pool_requests(dev)
    g = torch.Generator().manual_seed(2)
    caps = {k: int(torch.randint(1, POOL_MAX_NEW + 1, (1,), generator=g)) for k in reqs}

    def run(dec):
        return dict(dec.run(((k, {"key": k}) for k in reqs), stop_after=caps))

    eager = _greedy_pool(llm, reqs, 999, 16, dev)
    eager.graph = None
    want = run(eager)
    before = profiler.counts()
    captured = _greedy_pool(llm, reqs, 999, 16, dev)
    rows0 = profiler.tally("moe.rows", (2, 3, 8), dev)[0].sum().item()
    got = run(captured)
    torch.cuda.synchronize()
    change = {k: v - before.get(k, 0) for k, v in profiler.counts().items()}
    assert captured.graph is not None
    for key in want:
        assert got[key].tolist() == want[key].tolist(), key
    assert change["pool.graph_captures"] == 1
    assert change["pool.graph_replays"] == change["pool.chunks"] > 0
    rows = profiler.tally("moe.rows", (2, 3, 8), dev)[0].sum().item() - rows0
    assert rows == change["pool.chunks"] * 3 * 4 * 3 * 2     # steps x slots x k x MoE layers


REFILL_SPEECH = 151646          # the speech token of the refill tests' prompts


@pytest.fixture(scope="module")
def front_half_model():
    """SenseVoiceSmall and Qwen2.5-1.5B at their published widths, cut to 3
    + 2 encoder blocks and 2 LLM layers, bf16 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from ps_slm_tpu_torch.config import half_audio_configs
    from ps_slm_tpu_torch.models.tasu import model_factory

    torch.manual_seed(0)
    tc, mc = half_audio_configs(enc_overrides={"num_blocks": 3, "tp_blocks": 2},
                                llm_overrides={"num_hidden_layers": 2})
    model = model_factory(tc, mc, dtype=torch.bfloat16, device="cuda")
    model.speech_token_id, model.pad_token_id = REFILL_SPEECH, 151643
    return model.eval()


def _refill_requests(seconds, dev) -> list:
    """B=1 batches as the collator gives them: prompts of 8 and 13 tokens,
    random audio of ``seconds`` each, padded to the 7.68 s bucket."""
    g = torch.Generator().manual_seed(len(seconds))
    out = []
    for i, sec in enumerate(seconds):
        s = (8, 13)[i % 2]
        ids = torch.randint(100, 1000, (1, s), generator=g)
        ids[0, 3] = REFILL_SPEECH
        valid = int(sec * 16000)
        wav = torch.zeros(1, -(-valid // 122880) * 122880)
        wav[0, :valid] = 0.1 * torch.randn(valid, generator=g)
        out.append((f"r{i}", {"input_ids": ids.to(dev),
                              "attention_mask": torch.ones(1, s, dtype=torch.bool, device=dev),
                              "waveform": wav.to(dev),
                              "waveform_length": torch.tensor([valid], dtype=torch.int32,
                                                              device=dev)}))
    return out


def _refill(model, requests, dev):
    """A greedy pool of as many slots as requests, refilled once with all
    of them, its B=k prefills' rows kept by slot."""
    from ps_slm_tpu_torch.inference.continuous import ContinuousGreedyDecoder

    dec = ContinuousGreedyDecoder(model, num_slots=len(requests), prefill_len=600,
                                  max_new_tokens=4, eos_token_id=151645, sync_every=2,
                                  device=dev)
    rows = {}
    insert = dec._insert_chunk

    def insert_chunk(slots, embeds, mask, pos, **kw):
        insert(slots, embeds, mask, pos, **kw)
        rows.update({s: (embeds[i], mask[i], pos[i]) for i, s in enumerate(slots.tolist())})

    dec._insert_chunk = insert_chunk
    dec._emitted_n, dec._free = [0] * dec.num_slots, []
    dec._refill_many([(i, k, b) for i, (k, b) in enumerate(requests)])
    torch.cuda.synchronize()
    return dec, rows


def test_a_refill_stacks_mixed_lengths_into_one_front_half_on_card(dev, front_half_model):
    """Six requests of 2.5-28 s (four waveform shapes) and two prompt
    widths: the refill runs the front half once, so it launches the
    encoder's flash and LayerNorm kernels as one B=1 front half does
    (``chip_smoke.py``'s launch counters), and each stacked row agrees with
    its own B=1 ``prepare_merged`` row: masks exact, positions exact where
    valid, the embeddings within 2% in norm at the valid positions (bf16:
    only the front half's GEMM shapes differ)."""
    import chip_smoke
    from ps_slm_tpu_torch.inference.continuous import _left_pad_merged, default_merge
    from ps_slm_tpu_torch.utils import profiler

    model = front_half_model
    requests = _refill_requests([2.5, 9.0, 17.0, 28.0, 5.0, 12.0], dev)
    merge = default_merge(model)
    counters = chip_smoke.kernel_counters()
    merge(requests[0][1])                                       # warm-up
    before = chip_smoke.launch_snapshot(counters)
    one = merge(requests[0][1])
    torch.cuda.synchronize()
    per_call = chip_smoke.launch_delta(counters, before)
    before, counted = chip_smoke.launch_snapshot(counters), profiler.counts()
    dec, rows = _refill(model, requests, dev)
    got = chip_smoke.launch_delta(counters, before)
    calls = profiler.counts()["pool.front_half_calls"] - counted.get("pool.front_half_calls", 0)
    assert calls == 1 and one is not None
    prefills = 2                                                # B=4 and B=2
    assert got["flash_attention_fwd"] == per_call["flash_attention_fwd"] + 2 * prefills
    assert got["layer_norm_fwd"] == per_call["layer_norm_fwd"] > 0
    worst = 0.0
    for slot, (key, batch) in enumerate(requests):
        embeds, mask, pos = rows[slot]
        want = _left_pad_merged(merge(batch), dec.prefill_len)
        assert torch.equal(mask, want[1][0]), key
        valid = mask.bool()
        assert torch.equal(pos[valid], want[2][0][valid]), key
        a, b = embeds[valid].float(), want[0][0][valid].float()
        worst = max(worst, float((a - b).norm() / b.norm()))
    print(f"stacked rows against B=1 rows: worst relative error {worst:.5f}")
    assert worst <= 0.02


def test_a_first_turnover_splits_by_the_byte_budget_on_card(dev, front_half_model):
    """64 requests of 2-30 s (log-uniform, seeded) refilled at once: the
    front half runs in the calls ``front_half_calls`` plans, more than one,
    each within ``FRONT_HALF_BYTES`` of posterior (rows x the call's longest
    frames x 25 055 x 4) and each but the last full: one more row would
    pass the budget."""
    from ps_slm_tpu_torch.inference import continuous
    from ps_slm_tpu_torch.utils import profiler

    g = torch.Generator().manual_seed(7)
    seconds = (2.0 * 15.0 ** torch.rand(64, generator=g)).tolist()
    requests = _refill_requests(seconds, dev)
    batches = [b for _, b in requests]
    plan = continuous.front_half_calls(batches, 25055)
    frames = [continuous._frames(b) for b in batches]

    def posterior(call):
        return len(call) * max(frames[i] for i in call) * 25055 * 4

    counted = profiler.counts()
    torch.cuda.reset_peak_memory_stats()
    _refill(front_half_model, requests, dev)
    calls = profiler.counts()["pool.front_half_calls"] - counted.get("pool.front_half_calls", 0)
    print(f"64 requests: {len(plan)} front-half calls of {[len(c) for c in plan]} rows; "
          f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    assert calls == len(plan) > 1
    assert sorted(i for call in plan for i in call) == list(range(64))
    assert all(posterior(c) <= continuous.FRONT_HALF_BYTES for c in plan)
    for call, nxt in zip(plan, plan[1:]):
        assert posterior(call + nxt[:1]) > continuous.FRONT_HALF_BYTES
