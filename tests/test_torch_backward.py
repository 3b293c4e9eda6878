"""PyTorch port: the backward kernels' plain versions against the JAX package.

On CPU tensors the port's backward wrappers take their plain versions, so
these tests pin the arithmetic that the CUDA kernels repeat.  The JAX side
runs its Pallas kernels in interpret mode (``_flash_bwd`` with 16-blocks,
``fused_layer_norm`` / ``fused_rms_norm`` at d = 40, not a multiple of
128, and LayerNorm at the odd d = 263), as tests/test_flash_attention.py
and tests/test_norms.py do.
Inputs come from numpy with a fixed seed.  Tolerance: 1e-5 absolute and
relative (fp32; the two sides sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_slm_tpu.ops import flash_attention as jfa
from ps_slm_tpu.ops import norms as jnorms
from ps_slm_tpu_torch.ops import flash_attention as tfa
from ps_slm_tpu_torch.ops import norms as tnorms

TOL = dict(atol=1e-5, rtol=1e-5)
BLOCK = 16

# (b, s, hq, hkv, d, causal, mask builder): the three cases of
# tests/test_torch_ops.py
FLASH_CASES = {
    # encoder: non-causal self-attention over right-padded rows
    "noncausal_padded": (
        2, 40, 2, 2, 32, False, lambda: np.arange(40)[None, :] < np.array([40, 23])[:, None],
    ),
    # LLM: causal GQA, left-padded rows, one row with no valid key
    "causal_gqa_left_padded": (
        3, 48, 4, 2, 32, True,
        lambda: np.arange(48)[None, :] >= np.array([0, 13, 48])[:, None],
    ),
    # ragged S (not a multiple of any block)
    "causal_ragged": (1, 50, 2, 2, 16, True, lambda: np.ones((1, 50), bool)),
}


def _jax_flash_bwd(q, k, v, dout, mask, causal):
    """JAX ``_flash_fwd`` then ``_flash_bwd`` (interpret mode) on the
    [B,S,H,D] inputs padded to 16-blocks -> (dq, dk, dv) [B,S,H,D]."""
    b, s, _, d = q.shape
    start, end = jfa._window_from_mask(jnp.asarray(mask), b, s)

    def prep(x):
        return jfa._pad_to(jnp.swapaxes(jnp.asarray(x), 1, 2), 2, BLOCK)

    scale = d ** -0.5
    _, res = jfa._flash_fwd(prep(q), prep(k), prep(v), start, end, causal, scale, BLOCK, BLOCK)
    dq, dk, dv, _, _ = jfa._flash_bwd(causal, scale, BLOCK, BLOCK, res, prep(dout))
    return [np.asarray(jnp.swapaxes(x[:, :, :s], 1, 2)) for x in (dq, dk, dv)]


def _flash_inputs(case):
    b, s, hq, hkv, d, causal, mk = FLASH_CASES[case]
    rng = np.random.default_rng(sorted(FLASH_CASES).index(case) + 10)
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    dout = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    return q, k, v, dout, mk(), causal


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_backward_matches_jax_kernels(case):
    q, k, v, dout, mask, causal = _flash_inputs(case)
    b, s, _, d = q.shape
    want = _jax_flash_bwd(q, k, v, dout, mask, causal)

    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    start, end = tfa.window_from_mask(torch.from_numpy(mask), b, s, "cpu")
    out, lse = tfa.flash_attention_ref(tq, tk, tv, start, end, causal=causal, scale=d ** -0.5)
    got = tfa.flash_attention_bwd_ref(
        tq, tk, tv, start, end, out, lse, tdo, causal=causal, scale=d ** -0.5
    )
    for g, w in zip(got, want):
        assert not torch.isnan(g).any()
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    # a query row with no valid key gets no gradient
    empty = (lse == tfa.NEG_INF).transpose(1, 2)                    # [B,S,Hq]
    assert torch.equal(got[0][empty], torch.zeros_like(got[0][empty]))


@pytest.mark.parametrize("shape", [(3, 5, 40), (7, 40), (9, 263)])
def test_layer_norm_plain_backward_matches_jax(shape):
    rng = np.random.default_rng(11)
    x = rng.normal(size=shape).astype(np.float32) * 3 + 1
    w = (1 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    b = (0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    want = jax.grad(
        lambda x_, w_, b_: jnp.sum(jnorms.fused_layer_norm(x_, w_, b_) * g), argnums=(0, 1, 2)
    )(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))

    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    _, mu, rstd = tnorms.layer_norm_ref(tx, tw, tb)
    got = tnorms.layer_norm_bwd_ref(tx, tw, mu, rstd, torch.from_numpy(g))
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), **TOL)


@pytest.mark.parametrize("shape", [(3, 5, 40), (7, 40)])
def test_rms_norm_plain_backward_matches_jax(shape):
    rng = np.random.default_rng(12)
    x = rng.normal(size=shape).astype(np.float32) * 2
    w = (1 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    jx, jw, jg = jnp.asarray(x), jnp.asarray(w), jnp.asarray(g)
    want_kernel = jax.grad(
        lambda x_, w_: jnp.sum(jnorms.fused_rms_norm(x_, w_) * jg), argnums=(0, 1)
    )(jx, jw)
    _, (_, _, jrstd) = jnorms._rms_ref_fwd(jx, jw, 1e-6)
    want_ref = jnorms._rms_ref_bwd(1e-6, (jx, jw, jrstd), jg)

    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    _, rstd = tnorms.rms_norm_ref(tx, tw)
    got = tnorms.rms_norm_bwd_ref(tx, tw, rstd, torch.from_numpy(g))
    for want in (want_kernel, want_ref):
        for a, e in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(e), **TOL)


def _grads(out, inputs, g):
    return torch.autograd.grad(out, inputs, g)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_function_matches_autograd_of_plain_forward(case):
    q, k, v, dout, mask, causal = _flash_inputs(case)
    b, s, _, d = q.shape
    inputs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    tmask = torch.from_numpy(mask)
    got = _grads(tfa.flash_attention(*inputs, kv_mask=tmask, causal=causal), inputs,
                 torch.from_numpy(dout))
    start, end = tfa.window_from_mask(tmask, b, s, "cpu")
    ref_out, _ = tfa.flash_attention_ref(*inputs, start, end, causal=causal, scale=d ** -0.5)
    want = _grads(ref_out, inputs, torch.from_numpy(dout))
    for a, e in zip(got, want):
        assert not torch.isnan(a).any()
        torch.testing.assert_close(a, e, **TOL)


def test_norm_functions_match_autograd_of_plain_forward():
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(size=(4, 6, 40)).astype(np.float32) * 2 + 0.5)
    w = torch.from_numpy((1 + 0.1 * rng.normal(size=40)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=40)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(4, 6, 40)).astype(np.float32))
    inputs = [t.clone().requires_grad_(True) for t in (x, w, b)]
    got = _grads(tnorms.LayerNormFn.apply(*inputs, 1e-5), inputs, g)
    want = _grads(tnorms.layer_norm_ref(*inputs)[0], inputs, g)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, **TOL)
    inputs = inputs[:2]
    got = _grads(tnorms.RMSNormFn.apply(*inputs, 1e-6), inputs, g)
    want = _grads(tnorms.rms_norm_ref(*inputs)[0], inputs, g)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, **TOL)
    # frozen weights: only dx flows, and no weight gradient is summed
    xg = x.clone().requires_grad_(True)
    (dx,) = _grads(tnorms.RMSNormFn.apply(xg, w, 1e-6), [xg], g)
    torch.testing.assert_close(dx, tnorms.rms_norm_bwd_ref(x, w, tnorms.rms_norm_ref(x, w)[1], g)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_backward_wrappers_take_plain_versions_without_counting(dtype):
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.normal(size=(4, 40)).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.normal(size=(4, 40)).astype(np.float32)).to(dtype)
    w = torch.ones(40, dtype=dtype)
    before = (tnorms.layer_norm_bwd.launches, tnorms.rms_norm_bwd.launches,
              tfa.flash_attention_dq.launches, tfa.flash_attention_dkv.launches)
    _, mu, rstd = tnorms.layer_norm_ref(x, w, w)
    got = tnorms.layer_norm_bwd(x, w, mu, rstd, g)
    for a, e in zip(got, tnorms.layer_norm_bwd_ref(x, w, mu, rstd, g)):
        assert a.dtype == dtype and torch.equal(a, e)
    assert tnorms.layer_norm_bwd(x, w, mu, rstd, g, weight_grad=False)[1:] == (None, None)
    _, rstd = tnorms.rms_norm_ref(x, w)
    for a, e in zip(tnorms.rms_norm_bwd(x, w, rstd, g), tnorms.rms_norm_bwd_ref(x, w, rstd, g)):
        assert torch.equal(a, e)

    q, do = x.reshape(1, 4, 2, 20), g.reshape(1, 4, 2, 20)
    start, end = tfa.window_from_mask(None, 1, 4, "cpu")
    out, lse = tfa.flash_attention_ref(q, q, q, start, end, causal=True, scale=0.5)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    want = tfa.flash_attention_bwd_ref(q, q, q, start, end, out, lse, do, causal=True, scale=0.5)
    dq = tfa.flash_attention_dq(q, q, q, start, end, out, lse, do, delta, causal=True, scale=0.5)
    dk, dv = tfa.flash_attention_dkv(q, q, q, start, end, out, lse, do, delta, causal=True, scale=0.5)
    for a, e in zip((dq, dk, dv), want):
        assert a.dtype == dtype and torch.equal(a, e)
    after = (tnorms.layer_norm_bwd.launches, tnorms.rms_norm_bwd.launches,
             tfa.flash_attention_dq.launches, tfa.flash_attention_dkv.launches)
    assert after == before
