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
plain autograd: a whole attention and two norms.
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


def _rms_inputs(dev, dtype, n, d, offset, seed):
    """x, w, g for the RMSNorm tests; x and g contiguous, ``offset``
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
    x, w, g = _rms_inputs(dev, dtype, n, d, offset, n + d)
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
    x, w, g = _rms_inputs(dev, dtype, 2715, d, 0, 11)
    _, rstd = norms.rms_norm_ref(x, w)
    first = norms.rms_norm_bwd(x, w, rstd, g)
    second = norms.rms_norm_bwd(x, w, rstd, g)
    frozen = norms.rms_norm_bwd(x, w, rstd, g, weight_grad=False)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert frozen[1] is None and torch.equal(frozen[0], first[0])


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
