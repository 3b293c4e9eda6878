"""PyTorch port: encoder, projector and Qwen2 against the JAX package.

Weights are the JAX ``init_params`` output passed through
``ps_slm_tpu_torch.convert``; inputs come from numpy with a fixed seed.
Tolerances (fp32): 1e-5 for encoder and projector outputs, 1e-4 for
logits, where a matmul over the hidden width adds rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_slm_tpu.config import ModelConfig as JaxModelConfig
from ps_slm_tpu.inference import generate as jgen
from ps_slm_tpu.models import projector as jproj
from ps_slm_tpu.models import qwen2 as jqwen2
from ps_slm_tpu.models import sensevoice as jsv
from ps_slm_tpu.models.tasu import encode_speech as jax_encode_speech
from ps_slm_tpu_torch import convert
from ps_slm_tpu_torch.inference.generate import _prefill, _step
from ps_slm_tpu_torch.models.projector import LinearSiLUProjector
from ps_slm_tpu_torch.models.qwen2 import Qwen2Config, Qwen2Model
from ps_slm_tpu_torch.models.sensevoice import SenseVoiceConfig, SenseVoiceEncoder
from ps_slm_tpu_torch.models.tasu import encode_speech

OPS_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _torch(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def test_encode_speech_matches_jax():
    cfg = jsv.SenseVoiceConfig.tiny()
    params = jsv.init_params(jax.random.PRNGKey(1), cfg)
    enc = SenseVoiceEncoder(SenseVoiceConfig.tiny())
    enc.load_state_dict(convert.encoder_state_dict(_numpy_tree(params)))

    rng = np.random.default_rng(2)
    feats = rng.normal(size=(3, 9, cfg.input_size)).astype(np.float32)
    lens = np.array([9, 5, 0], np.int32)
    want = jax_encode_speech({"encoder": params}, cfg, jnp.asarray(feats), jnp.asarray(lens))
    with torch.no_grad():
        got = encode_speech(enc, _torch(feats), _torch(lens, torch.int64))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **OPS_TOL)


def test_linear_silu_projector_matches_jax():
    mc = JaxModelConfig(encoder_dim=11, llm_dim=24)
    params = jproj.init_linear_silu(jax.random.PRNGKey(3), mc)
    module = LinearSiLUProjector(11, 24)
    module.load_state_dict(convert.projector_state_dict(_numpy_tree(params)))
    x = np.random.default_rng(4).normal(size=(2, 7, 11)).astype(np.float32)
    want = jproj.apply_linear_silu(params, mc, jnp.asarray(x))
    with torch.no_grad():
        got = module(_torch(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OPS_TOL)


def _qwen2_pair(tie=True):
    jcfg = jqwen2.Qwen2Config.tiny(tie_word_embeddings=tie)
    params = jqwen2.init_params(jax.random.PRNGKey(5), jcfg)
    llm = Qwen2Model(Qwen2Config.tiny(tie_word_embeddings=tie))
    llm.load_state_dict(convert.qwen2_state_dict(_numpy_tree(params)))
    return jcfg, params, llm.eval()


def _left_padded_prompt(jcfg, params, b=2, s=9, pads=(0, 3)):
    rng = np.random.default_rng(6)
    ids = rng.integers(0, jcfg.vocab_size, size=(b, s))
    mask = np.ones((b, s), bool)
    for r, p in enumerate(pads):
        mask[r, :p] = False
    pos = np.clip(np.cumsum(mask, -1) - 1, 0, None).astype(np.int32)
    emb = np.asarray(jqwen2.embed(params, jnp.asarray(ids)))
    return emb, mask, pos


@pytest.mark.parametrize("tie", [True, False])
def test_qwen2_forward_matches_jax(tie):
    jcfg, params, llm = _qwen2_pair(tie)
    emb, mask, pos = _left_padded_prompt(jcfg, params)
    hidden, _ = jqwen2.forward(
        params, jcfg, jnp.asarray(emb), attention_mask=jnp.asarray(mask),
        position_ids=jnp.asarray(pos),
    )
    want = np.asarray(jqwen2.unembed(params, hidden))
    with torch.no_grad():
        got_h, _ = llm(_torch(emb), _torch(mask), _torch(pos, torch.int64))
        got = llm.unembed(got_h)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(hidden), **LOGIT_TOL)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


def test_qwen2_prefill_and_cached_steps_match_jax():
    jcfg, params, llm = _qwen2_pair()
    emb, mask, pos = _left_padded_prompt(jcfg, params)
    capacity = emb.shape[1] + 4
    want, cache, full_mask = jgen._prefill(
        params, jcfg, jnp.asarray(emb), jnp.asarray(mask), jnp.asarray(pos),
        capacity, jnp.float32,
    )
    with torch.no_grad():
        got, tcache, tmask = _prefill(
            llm, _torch(emb), _torch(mask), _torch(pos, torch.int64), capacity
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)

    s = emb.shape[1]
    next_pos = pos[:, -1] + 1
    tokens = np.asarray(want).argmax(-1)
    for t in range(1, 4):
        index = s + t - 1
        full_mask = full_mask.at[:, index].set(True)
        tmask[:, index] = True
        positions = next_pos + t - 1
        want, cache = jgen._step(
            params, jcfg, cache, full_mask, jnp.asarray(tokens, jnp.int32),
            jnp.asarray(positions), index,
        )
        with torch.no_grad():
            got, tcache = _step(
                llm, tcache, tmask, _torch(tokens, torch.int64),
                _torch(positions, torch.int64), index,
            )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        tokens = np.asarray(want).argmax(-1)
