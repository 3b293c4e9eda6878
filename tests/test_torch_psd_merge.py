"""PyTorch port: PSD and the audio/text merge against the JAX package.

Lengths, masks, ids and position ids must match exactly; pooled features
within 1e-5 (fp32 segment means summed in another order); merged
embeddings exactly (the merge only moves values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_slm_tpu.ops.merge import merge_audio_text as jax_merge
from ps_slm_tpu.ops.psd import psd as jax_psd
from ps_slm_tpu_torch.ops.merge import merge_audio_text
from ps_slm_tpu_torch.ops.psd import psd

SPEECH = 50


def _posterior(rng, ids, blank_boost):
    """Softmax posterior whose argmax is ``ids``; ``blank_boost`` [B,T]
    raises the blank probability (blank id 0) on chosen frames."""
    b, t = ids.shape
    v = 7
    logits = 0.1 * rng.normal(size=(b, t, v))
    logits[np.arange(b)[:, None], np.arange(t)[None, :], ids] += 5.0
    logits[..., 0] += blank_boost
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("pool_posterior", [True, False])
def test_psd_matches_jax(pool_posterior):
    rng = np.random.default_rng(0)
    ids = np.array([
        [3, 3, 0, 3, 3, 5, 5, 5, 0, 0, 2, 4, 4, 1],
        [0, 6, 6, 6, 0, 6, 2, 2, 3, 0, 1, 1, 1, 1],
        [4, 4, 4, 4, 0, 0, 0, 5, 5, 2, 2, 2, 2, 2],
    ])
    boost = np.zeros(ids.shape)
    boost[0, [2, 8]] = 8.0      # confident blanks: dropped (p_blank >= 0.9)
    boost[1, 4] = 8.0
    boost[2, 5] = 8.0
    boost[1, 0] = boost[2, 6] = -3.5  # unsure blanks: kept as single frames
    post = _posterior(rng, ids, boost)
    lens = np.array([14, 9, 0], np.int32)
    feats = post if pool_posterior else rng.normal(size=(3, 14, 5)).astype(np.float32)

    want, want_lens = jax_psd(jnp.asarray(feats), jnp.asarray(lens), jnp.asarray(post))
    got, got_lens = psd(torch.from_numpy(feats), torch.from_numpy(lens), torch.from_numpy(post))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert got.shape == feats.shape and got.dtype == torch.float32


def _merge_inputs(rng, left):
    b, s, a, e = 3, 8, 6, 5
    ids = rng.integers(1, 40, size=(b, s)).astype(np.int32)
    ids[0, 2] = ids[1, 5] = ids[2, 0] = SPEECH
    mask = np.ones((b, s), bool)
    if left:
        mask[1, :2] = False        # left-padded text in row 1
    else:
        mask[0, -3:] = False       # right-padded text in row 0
    ids[~mask] = 0
    labels = np.where(mask, ids, -100).astype(np.int32)
    audio = rng.normal(size=(b, a, e)).astype(np.float32)
    emb = rng.normal(size=(b, s, e)).astype(np.float32)
    audio_lens = np.array([6, 3, 0], np.int32)   # all but one shorter than A
    return audio, audio_lens, emb, ids, mask, labels


@pytest.mark.parametrize("left_padding", [False, True])
def test_merge_matches_jax(left_padding):
    rng = np.random.default_rng(1)
    audio, audio_lens, emb, ids, mask, labels = _merge_inputs(rng, left_padding)
    want = jax_merge(
        jnp.asarray(audio), jnp.asarray(audio_lens), jnp.asarray(emb),
        jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(labels),
        speech_token_id=SPEECH, pad_token_id=0, left_padding=left_padding,
    )
    got = merge_audio_text(
        torch.from_numpy(audio), torch.from_numpy(audio_lens), torch.from_numpy(emb),
        torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(labels),
        speech_token_id=SPEECH, pad_token_id=0, left_padding=left_padding,
    )
    assert got.embeds.shape == (3, 8 + 6 - 1, 5)
    np.testing.assert_array_equal(got.embeds.numpy(), np.asarray(want.embeds))
    np.testing.assert_array_equal(got.attention_mask.numpy(), np.asarray(want.attention_mask))
    np.testing.assert_array_equal(got.position_ids.numpy(), np.asarray(want.position_ids))
    np.testing.assert_array_equal(got.input_ids.numpy(), np.asarray(want.input_ids))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
