"""PyTorch port: ops/ctc.py against the JAX package (CPU).

The same seeded numpy log-probabilities go through the JAX functions
(``optax.ctc_loss`` inside ``ctc_loss``, the jitted Viterbi) and the port's.

Tolerances (fp32): losses 1e-5 relative; gradients with respect to the
logits 1e-5 (absolute and relative) on feasible and padded rows.  A row
whose labels cannot fit its frames stays finite (optax's log(0) is -1e5):
its loss within 1e-5 relative.  Its gradient is ill-conditioned in fp32:
the lattice lives near -1e5, where fp32 values are 2^-7 apart, so one
rounding in a logaddexp moves exp(x - out) by up to 0.8%.  It is held
against the same recursion in float64: the port's fp32 gradient within
2e-3 of the row's largest element, JAX's within 1e-2 (JAX's fp32 is
5.7e-3 of the row's largest off float64 on these inputs, the port's 9e-4).
The alignments and greedy decodes are integers: equal element for element.
About 14 s alone on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ps_slm_tpu.ops import ctc as jctc
from ps_slm_tpu_torch.ops import ctc

B, T, V, L = 5, 14, 9, 5


def _case(seed):
    """Ragged logits and labels; row 3 infeasible (5 labels in 3 frames),
    row 4 with no label; labels padded with 0."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, T, V)) * 2).astype(np.float32)
    logit_lens = np.array([14, 11, 9, 3, 7])
    label_lens = np.array([5, 3, 4, 5, 0])
    labels = rng.integers(1, V, size=(B, L)).astype(np.int32)
    labels[0, 2] = labels[0, 1]        # a repeated label needs a blank between
    labels[np.arange(L)[None, :] >= label_lens[:, None]] = 0
    return logits, logit_lens, labels, label_lens


def _jax_loss_and_grad(logits, logit_lens, labels, label_lens):
    def per_row(lg):
        return jax.vmap(lambda a, b, c, d: jctc.ctc_loss(a[None], b[None], c[None], d[None]))(
            lg, jnp.asarray(logit_lens), jnp.asarray(labels), jnp.asarray(label_lens))

    rows = per_row(jnp.asarray(logits))
    mean_grad = jax.grad(lambda lg: jctc.ctc_loss(
        lg, jnp.asarray(logit_lens), jnp.asarray(labels), jnp.asarray(label_lens)))(
        jnp.asarray(logits))
    return np.asarray(rows), np.asarray(mean_grad)


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_loss_and_gradient_match_jax(seed):
    logits, logit_lens, labels, label_lens = _case(seed)
    want_rows, want_grad = _jax_loss_and_grad(logits, logit_lens, labels, label_lens)
    x = torch.tensor(logits, requires_grad=True)
    loss = ctc.ctc_loss(x, torch.tensor(logit_lens), torch.tensor(labels),
                        torch.tensor(label_lens))
    loss.backward()
    rows = ctc._ctc_nll(torch.tensor(logits), torch.tensor(logit_lens), torch.tensor(labels),
                        torch.tensor(label_lens), 0).numpy()
    np.testing.assert_allclose(rows, want_rows, rtol=1e-5)
    np.testing.assert_allclose(loss.item(), want_rows.mean(), rtol=1e-5)
    assert np.isfinite(rows).all() and rows[3] > 1e5     # infeasible, finite
    got = x.grad.numpy()
    feasible = [0, 1, 2, 4]
    np.testing.assert_allclose(got[feasible], want_grad[feasible], atol=1e-5, rtol=1e-5)
    x64 = torch.tensor(logits, dtype=torch.float64, requires_grad=True)
    ctc.ctc_loss(x64, torch.tensor(logit_lens), torch.tensor(labels),
                 torch.tensor(label_lens)).backward()
    exact = x64.grad.numpy()
    np.testing.assert_allclose(exact[feasible], want_grad[feasible], atol=1e-5, rtol=1e-5)
    scale = np.abs(exact[3]).max()
    assert np.abs(got[3] - exact[3]).max() <= 2e-3 * scale
    assert np.abs(want_grad[3] - exact[3]).max() <= 1e-2 * scale
    # padded frames get no gradient
    assert not got[2, 9:].any() and not got[3, 3:].any()


def test_ctc_loss_matches_torch_on_feasible_rows():
    logits, logit_lens, labels, label_lens = _case(2)
    feasible = [0, 1, 2, 4]
    x = torch.tensor(logits[feasible])
    ours = ctc._ctc_nll(x, torch.tensor(logit_lens[feasible]), torch.tensor(labels[feasible]),
                        torch.tensor(label_lens[feasible]), 0)
    ref = F.ctc_loss(torch.log_softmax(x, -1).transpose(0, 1), torch.tensor(labels[feasible]),
                     torch.tensor(logit_lens[feasible]), torch.tensor(label_lens[feasible]),
                     blank=0, reduction="none", zero_infinity=False)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=1e-5)
    # the one infeasible row: F.ctc_loss gives inf, the port stays finite
    inf = F.ctc_loss(torch.log_softmax(torch.tensor(logits[3:4]), -1).transpose(0, 1),
                     torch.tensor(labels[3:4]), torch.tensor([3]), torch.tensor([5]),
                     reduction="none")
    assert torch.isinf(inf).all()


@pytest.mark.parametrize("seed", range(4))
def test_forced_align_equals_jax(seed):
    rng = np.random.default_rng(seed)
    lp = np.array(jax.nn.log_softmax(rng.normal(size=(B, T, V)).astype(np.float32) * 3))
    il = rng.integers(1, T + 1, size=B)
    il[0] = T
    tl = np.minimum(rng.integers(0, L + 1, size=B), il // 2)
    tg = rng.integers(1, V, size=(B, L)).astype(np.int32)
    tg[1, 1] = tg[1, 0]
    # exact ties between paths: equal log-probs in two frames
    lp[2, 3] = lp[2, 4]
    want = np.asarray(jctc.ctc_forced_align(jnp.asarray(lp), jnp.asarray(tg),
                                            jnp.asarray(il), jnp.asarray(tl)))
    got = ctc.ctc_forced_align(torch.tensor(lp), torch.tensor(tg), torch.tensor(il),
                               torch.tensor(tl)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("seed", range(3))
def test_greedy_decode_equals_jax(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 4, size=(B, T))       # runs and blanks
    lp = np.full((B, T, V), -5.0, np.float32)
    np.put_along_axis(lp, ids[..., None], 0.0, axis=-1)
    lens = rng.integers(0, T + 1, size=B)
    want_ids, want_lens = jctc.ctc_greedy_decode(jnp.asarray(lp), jnp.asarray(lens))
    got_ids, got_lens = ctc.ctc_greedy_decode(torch.tensor(lp), torch.tensor(lens))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
