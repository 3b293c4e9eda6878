"""PyTorch port: attention and norm ops against the JAX package (CPU, fp32).

On CPU tensors the port's kernel wrappers take their plain versions, so
these tests pin the arithmetic that the CUDA kernels repeat.  The JAX side
runs its Pallas kernels in interpret mode, as tests/test_flash_attention.py
and tests/test_norms.py do.  Tolerance: 1e-5 absolute and relative (fp32;
the two sides sum in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_slm_tpu.models.layers import layer_norm as jax_layer_norm
from ps_slm_tpu.ops import flash_attention as jfa
from ps_slm_tpu.ops import norms as jnorms
from ps_slm_tpu.ops.attention import mha_reference as jax_mha
from ps_slm_tpu_torch.ops import attention as tattn
from ps_slm_tpu_torch.ops import flash_attention as tfa
from ps_slm_tpu_torch.ops import norms as tnorms

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(rng, b, s, t, hq, hkv, d):
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, t, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, t, hkv, d)).astype(np.float32)
    return q, k, v


def _jax_flash(q, k, v, mask, causal, block=16):
    """JAX flash (interpret mode) -> (out [B,S,H,D], lse [B,H,S])."""
    b, s, _, d = q.shape
    t = k.shape[1]
    start, end = jfa._window_from_mask(jnp.asarray(mask), b, t)
    qt = jfa._pad_to(jnp.swapaxes(jnp.asarray(q), 1, 2), 2, block)
    kt = jfa._pad_to(jnp.swapaxes(jnp.asarray(k), 1, 2), 2, block)
    vt = jfa._pad_to(jnp.swapaxes(jnp.asarray(v), 1, 2), 2, block)
    out, lse = jfa._flash_fwd_impl(
        qt, kt, vt, start, end, causal, d ** -0.5, block, block
    )
    return (
        np.asarray(jnp.swapaxes(out[:, :, :s], 1, 2)),
        np.asarray(lse[:, :, :s, 0]),
    )


def _prefix_mask(lens, t):
    return np.arange(t)[None, :] < np.asarray(lens)[:, None]


# (b, s, hq, hkv, d, causal, mask builder)
FLASH_CASES = {
    # encoder: non-causal self-attention over right-padded rows
    "noncausal_padded": (2, 40, 2, 2, 32, False, lambda: _prefix_mask([40, 23], 40)),
    # LLM prefill: causal GQA, left-padded rows, one row with no valid key;
    # query rows left of the window have no valid key either
    "causal_gqa_left_padded": (
        3, 48, 4, 2, 32, True,
        lambda: np.arange(48)[None, :] >= np.array([0, 13, 48])[:, None],
    ),
    # ragged S (not a multiple of any block)
    "causal_ragged": (1, 50, 2, 2, 16, True, lambda: np.ones((1, 50), bool)),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_jax_flash_and_mha(case):
    b, s, hq, hkv, d, causal, mk = FLASH_CASES[case]
    rng = np.random.default_rng(sorted(FLASH_CASES).index(case))
    q, k, v = _qkv(rng, b, s, s, hq, hkv, d)
    mask = mk()

    want_out, want_lse = _jax_flash(q, k, v, mask, causal)
    ref = np.asarray(jax_mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_mask=jnp.asarray(mask), causal=causal,
    ))

    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    start, end = tfa.window_from_mask(torch.from_numpy(mask), b, s, "cpu")
    out, lse = tfa.flash_attention_fwd(
        tq, tk, tv, start, end, causal=causal, scale=d ** -0.5
    )
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    # rows with no valid key: lse is exactly NEG_INF in both, out exactly 0
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)
    empty = want_lse == jfa.NEG_INF
    assert np.array_equal(lse.numpy() == tfa.NEG_INF, empty)
    assert not np.isnan(out.numpy()).any()

    got = tattn.attention(tq, tk, tv, torch.from_numpy(mask), causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_window_from_mask_matches_jax():
    mask = np.zeros((4, 9), bool)
    mask[0, :] = True
    mask[1, 3:] = True
    mask[2, :5] = True                    # row 3 has no valid key
    start, end = tfa.window_from_mask(torch.from_numpy(mask), 4, 9, "cpu")
    jstart, jend = jfa._window_from_mask(jnp.asarray(mask), 4, 9)
    np.testing.assert_array_equal(start.numpy(), np.asarray(jstart))
    np.testing.assert_array_equal(end.numpy(), np.asarray(jend))
    s0, e0 = tfa.window_from_mask(None, 4, 9, "cpu")
    assert s0.tolist() == [0] * 4 and e0.tolist() == [9] * 4


def test_mha_reference_with_q_offset_matches_jax():
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 3, 10, 4, 2, 16)
    mask = rng.uniform(size=(2, 10)) > 0.3
    offset = np.array([5, 7], np.int32)
    want = jax_mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_mask=jnp.asarray(mask),
        causal=True, q_offset=jnp.asarray(offset),
    )
    got = tattn.mha_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_mask=torch.from_numpy(mask), causal=True,
        q_offset=torch.from_numpy(offset),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_attention_matches_jax_masked_reference():
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 3, 1, 12, 4, 2, 16)
    mask = np.arange(12)[None, :] >= np.array([0, 4, 9])[:, None]
    mask[:, 10:] = False                  # cells not written yet
    want = jax_mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_mask=jnp.asarray(mask)
    )
    got = tattn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_is_full_sequence_only():
    x = torch.zeros(1, 2, 2, 8)
    with pytest.raises(ValueError, match="full-sequence"):
        tattn.attention(x, torch.zeros(1, 3, 2, 8), torch.zeros(1, 3, 2, 8))


@pytest.mark.parametrize("shape", [(3, 5, 24), (7, 40), (3, 560)])
def test_layer_norm_plain_matches_jax(shape):
    rng = np.random.default_rng(5)
    x = rng.normal(size=shape).astype(np.float32) * 3 + 1
    w = (1 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    b = (0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    jy, jmu, jrstd = jnorms._ln_fwd(jx, jw, jb, 1e-5)
    rows = int(np.prod(shape[:-1]))

    y, mu, rstd = tnorms.layer_norm_ref(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    )
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jax_layer_norm(jx, jw, jb)), **TOL)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jnorms.fused_layer_norm(jx, jw, jb)), **TOL
    )
    np.testing.assert_allclose(mu.reshape(-1).numpy(), np.asarray(jmu)[:rows, 0], **TOL)
    np.testing.assert_allclose(rstd.reshape(-1).numpy(), np.asarray(jrstd)[:rows, 0], **TOL)


@pytest.mark.parametrize("shape", [(3, 5, 24), (7, 40)])
def test_rms_norm_plain_matches_jax(shape):
    rng = np.random.default_rng(6)
    x = rng.normal(size=shape).astype(np.float32) * 2
    w = (1 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    jy, jrstd = jnorms._rms_fwd(jx, jw, 1e-6)
    rows = int(np.prod(shape[:-1]))

    y, rstd = tnorms.rms_norm_ref(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jnorms.rms_norm_ref(jx, jw, 1e-6)), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jnorms.fused_rms_norm(jx, jw)), **TOL)
    np.testing.assert_allclose(rstd.reshape(-1).numpy(), np.asarray(jrstd)[:rows, 0], **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrappers_take_plain_versions_without_counting(dtype):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(4, 40)).astype(np.float32)).to(dtype)
    w = torch.ones(40, dtype=dtype)
    b = torch.zeros(40, dtype=dtype)
    before = (tnorms.layer_norm_fwd.launches, tnorms.rms_norm_fwd.launches,
              tfa.flash_attention_fwd.launches)
    y, _, _ = tnorms.layer_norm_fwd(x, w, b)
    assert y.dtype == dtype
    assert torch.equal(y, tnorms.layer_norm_ref(x, w, b)[0])
    y, _ = tnorms.rms_norm_fwd(x, w)
    assert torch.equal(y, tnorms.rms_norm_ref(x, w)[0])
    q = x.reshape(1, 4, 2, 20)
    start, end = tfa.window_from_mask(None, 1, 4, "cpu")
    out, _ = tfa.flash_attention_fwd(q, q, q, start, end, causal=True, scale=0.5)
    assert out.dtype == dtype
    after = (tnorms.layer_norm_fwd.launches, tnorms.rms_norm_fwd.launches,
             tfa.flash_attention_fwd.launches)
    assert after == before
