"""PyTorch port: draft-verified (speculative) greedy decoding against the
JAX package.

A tiny Qwen2 (JAX weights, converted) decodes three left-padded prompts.
For random, oracle (greedy's own tokens) and corrupted drafts, windows 2,
4 and 8 and the 16-bit and int8 KV caches, the port's tokens and number
of forwards must equal ``speculative_greedy_generate``'s, and the tokens
the port's own greedy decoding's (fp32, exact).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_slm_tpu.inference.generate import greedy_generate as jax_greedy
from ps_slm_tpu.inference.speculative import speculative_greedy_generate as jax_spec
from ps_slm_tpu.models import qwen2 as jqwen2
from ps_slm_tpu_torch import convert
from ps_slm_tpu_torch.inference.generate import greedy_generate
from ps_slm_tpu_torch.inference.speculative import speculative_greedy_generate
from ps_slm_tpu_torch.models import qwen2

MAX_NEW = 24


@functools.lru_cache(maxsize=None)
def _setup():
    """(JAX cfg, params, port LLM, inputs, EOS): EOS is a token greedy
    decoding emits mid-way in row 0, so rows end at different steps."""
    kw = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=8)
    jcfg = jqwen2.Qwen2Config.tiny(**kw)
    params = jqwen2.init_params(jax.random.PRNGKey(0), jcfg)
    llm = qwen2.Qwen2Model(qwen2.Qwen2Config.tiny(**kw))
    llm.load_state_dict(convert.qwen2_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, size=(3, 7))
    mask = np.ones((3, 7), bool)
    mask[1, :3] = False                                 # one left-padded row
    emb = np.asarray(jqwen2.embed(params, jnp.asarray(ids)))
    pos = np.clip(np.cumsum(mask, axis=-1) - 1, 0, None)
    first = np.asarray(jax_greedy(params, jcfg, jnp.asarray(emb), jnp.asarray(mask),
                                  jnp.asarray(pos), max_new_tokens=MAX_NEW, eos_token_id=63))
    return jcfg, params, llm.eval(), (emb, mask, pos), int(first[0, 9])


def _drafts(kind, want, eos):
    """[3, MAX_NEW] draft ids and their lengths."""
    if kind == "random":
        ids = np.random.default_rng(5).integers(0, 64, size=(3, MAX_NEW))
        return ids, np.array([16, 10, 0])               # an empty draft too
    if kind == "oracle":
        return want, np.array([int((row != eos).sum()) for row in want])
    flips = np.random.default_rng(11).random(want.shape) < 0.3
    return np.where(flips, (want + 7) % 64, want), np.full(3, MAX_NEW)


@pytest.mark.parametrize("kind", ["random", "oracle", "corrupted"])
@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("window", [2, 4, 8])
def test_speculative_tokens_and_forwards_equal_jax(window, kv_bits, kind):
    jcfg, params, llm, (emb, mask, pos), eos = _setup()
    jin = (jnp.asarray(emb), jnp.asarray(mask), jnp.asarray(pos))
    want = np.asarray(jax_greedy(params, jcfg, *jin, max_new_tokens=MAX_NEW, eos_token_id=eos,
                                 kv_bits=kv_bits))
    ids, lens = _drafts(kind, want, eos)
    jtok, jn = jax_spec(params, jcfg, *jin, jnp.asarray(ids, jnp.int32),
                        jnp.asarray(lens, jnp.int32), max_new_tokens=MAX_NEW,
                        eos_token_id=eos, window=window, kv_bits=kv_bits)
    tin = (torch.from_numpy(emb), torch.from_numpy(mask), torch.from_numpy(pos))
    got, n = speculative_greedy_generate(
        llm, *tin, torch.from_numpy(ids), torch.from_numpy(lens), max_new_tokens=MAX_NEW,
        eos_token_id=eos, window=window, kv_bits=kv_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtok))
    assert n == int(jn)
    greedy = greedy_generate(llm, *tin, max_new_tokens=MAX_NEW, eos_token_id=eos,
                             kv_bits=kv_bits)
    np.testing.assert_array_equal(got.numpy(), greedy.numpy())
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == eos).any() and not (want == eos).all(axis=1).any()
    if kind == "oracle" and window == 8:
        longest = int(max((row != eos).sum() for row in want)) + 1
        assert n <= max(-(-longest // 8) + 2, 3), (n, longest)


def test_speculative_refuses_a_one_token_window_and_zero_width_drafts_run():
    jcfg, params, llm, (emb, mask, pos), eos = _setup()
    tin = (torch.from_numpy(emb), torch.from_numpy(mask), torch.from_numpy(pos))
    with pytest.raises(ValueError, match=">= 2"):
        speculative_greedy_generate(llm, *tin, torch.zeros(3, 4, dtype=torch.long),
                                    torch.zeros(3, dtype=torch.long), window=1)
    got, _ = speculative_greedy_generate(
        llm, *tin, torch.zeros(3, 0, dtype=torch.long), torch.zeros(3, dtype=torch.long),
        max_new_tokens=MAX_NEW, eos_token_id=eos, window=4)
    greedy = greedy_generate(llm, *tin, max_new_tokens=MAX_NEW, eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), greedy.numpy())
