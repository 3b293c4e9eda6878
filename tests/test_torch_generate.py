"""PyTorch port: the whole serving slice against the JAX package.

One tiny audio-TASU model (``half_audio`` flags: CTC posterior + PSD +
linear-silu), built by the JAX factory and converted leaf by leaf into the
port's TasuModel.  ``prepare_merged`` must agree within 1e-5 (fp32) with
exact masks and positions, and ``generate(num_beams=1)`` must give exactly
the JAX tokens, including EOS fill and the early stop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_slm_tpu.config import ModelConfig as JaxModelConfig
from ps_slm_tpu.config import TrainConfig as JaxTrainConfig
from ps_slm_tpu.inference.generate import generate as jax_generate
from ps_slm_tpu.models import tasu as jtasu
from ps_slm_tpu_torch import convert
from ps_slm_tpu_torch.config import ModelConfig, TrainConfig
from ps_slm_tpu_torch.inference.generate import generate
from ps_slm_tpu_torch.models import tasu

SPEECH = 250
ENC_VOCAB, ENC_INPUT, LLM_DIM = 11, 24, 64   # the tiny configs' widths


def _pair(do_psd=True):
    flags = dict(ctc_posterior=True, do_psd=do_psd)
    jm = jtasu.model_factory(
        JaxTrainConfig(**flags),
        JaxModelConfig(llm_path="", encoder_dim=ENC_VOCAB, llm_dim=LLM_DIM),
        rng=jax.random.PRNGKey(0),
    )
    jm.speech_token_id = SPEECH
    pm = tasu.model_factory(
        TrainConfig(**flags), ModelConfig(encoder_dim=ENC_VOCAB, llm_dim=LLM_DIM),
        device="cpu",
    )
    pm.load_state_dict(convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params)))
    pm.speech_token_id = SPEECH
    return jm, pm


def _batch(b=3, s=10, a=8):
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 200, size=(b, s)).astype(np.int32)
    ids[:, 3] = SPEECH
    feats = rng.normal(size=(b, a, ENC_INPUT)).astype(np.float32)
    np_batch = {
        "input_ids": ids,
        "attention_mask": np.ones((b, s), bool),
        "input_features": feats,
        "input_feature_length": np.array([a, a - 3, 2], np.int32),
    }
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    tb["input_ids"] = tb["input_ids"].long()
    tb["input_feature_length"] = tb["input_feature_length"].long()
    return jb, tb


@pytest.mark.parametrize("do_psd", [True, False])
def test_prepare_merged_matches_jax(do_psd):
    jm, pm = _pair(do_psd)
    jb, tb = _batch()
    want = jtasu.prepare_merged(jm, jm.params, jb, None, left_padding=True, generate_mode=True)
    with torch.no_grad():
        got = tasu.prepare_merged(pm, tb, left_padding=True)
    np.testing.assert_allclose(got.embeds.numpy(), np.asarray(want.embeds), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got.attention_mask.numpy(), np.asarray(want.attention_mask))
    np.testing.assert_array_equal(got.position_ids.numpy(), np.asarray(want.position_ids))
    np.testing.assert_array_equal(got.input_ids.numpy(), np.asarray(want.input_ids))


def test_generate_greedy_tokens_equal_jax():
    jm, pm = _pair()
    jb, tb = _batch()
    kw = dict(num_beams=1, max_new_tokens=8)
    first = np.asarray(jax_generate(jm, jm.params, jb, eos_token_id=9, **kw))
    # make a token the JAX run emits mid-way the EOS: rows then end at
    # different steps, exercising EOS fill and (if all end) the early stop
    eos = int(first[0, 2])
    want = np.asarray(jax_generate(jm, jm.params, jb, eos_token_id=eos, **kw))
    got = generate(pm, tb, eos_token_id=eos, device="cpu", **kw)
    assert (want == eos).any()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("key_name", ["key", "rng"])
def test_generate_takes_the_jax_keywords_greedy_never_reads(key_name):
    """length_penalty (beam search only), key or its alias rng (sampling
    only) and spec_window (drafts only) are taken as the JAX generate
    takes them, and greedy gives the JAX tokens."""
    jm, pm = _pair()
    jb, tb = _batch()
    kw = dict(num_beams=1, max_new_tokens=8, eos_token_id=9, length_penalty=1.5, spec_window=4)
    want = np.asarray(jax_generate(jm, jm.params, jb, **kw, **{key_name: jax.random.PRNGKey(3)}))
    gen = torch.Generator().manual_seed(3)
    got = generate(pm, tb, device="cpu", **kw, **{key_name: gen})
    np.testing.assert_array_equal(got.numpy(), want)
