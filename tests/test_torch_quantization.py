"""PyTorch port: weight-only int8 / int4 and the int8 KV cache against the
JAX package.

Codes and scales must be bit-equal (both packages round half to even), the
quantized products within 1e-5 relative, and a quantized TasuModel's
logits within 1e-4 (fp32), its weights converted leaf by leaf from the JAX
factory's quantized pytree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_slm_tpu.config import ModelConfig as JaxModelConfig
from ps_slm_tpu.config import TrainConfig as JaxTrainConfig
from ps_slm_tpu.models import qwen2 as jqwen2
from ps_slm_tpu.models import quantization as jq
from ps_slm_tpu.models import tasu as jtasu
from ps_slm_tpu.training.checkpoint import export_reference_checkpoint as jax_export
from ps_slm_tpu.training.checkpoint import import_reference_checkpoint as jax_import
from ps_slm_tpu_torch import convert
from ps_slm_tpu_torch.config import ModelConfig, TrainConfig
from ps_slm_tpu_torch.models import quantization as q
from ps_slm_tpu_torch.models import qwen2, tasu
from ps_slm_tpu_torch.training import checkpoint

PRODUCT_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
SPEECH, ENC_VOCAB, ENC_INPUT, LLM_DIM = 250, 11, 24, 64


def _np(x):
    """A JAX leaf as numpy; integer codes (int4 included) as int8."""
    return np.asarray(x).astype(np.int8) if np.asarray(x).dtype.kind not in "fb" else np.asarray(x)


def _kernel(shape, seed=0):
    return (np.random.default_rng(seed).normal(size=shape) * 0.3).astype(np.float32)


@pytest.mark.parametrize("case", ["q8", "q4", "q4_indivisible", "kv"])
def test_codes_and_scales_bit_equal_jax(case):
    if case == "kv":
        # the cache quantizes inside the jitted forward, where XLA folds the
        # division by 127 into a multiply by its reciprocal (eager JAX
        # divides: other scales in about 4% of vectors)
        x = _kernel((64, 32, 2, 128)) * 4.0
        want = jax.jit(jq.quantize_kv)(jnp.asarray(x))
        got = q.quantize_kv(torch.from_numpy(x))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))
        np.testing.assert_array_equal(
            q.dequantize_kv(*got, torch.float32).numpy(),
            np.asarray(jq.dequantize_kv(*want, jnp.float32)))
        return
    w = _kernel((2, 256, 48))
    if case == "q8":
        want, got = jq.quantize_kernel(jnp.asarray(w)), q.quantize_kernel(torch.from_numpy(w))
        back = (q.dequantize_kernel(got), jq.dequantize_kernel(want))
    else:
        gs = 128 if case == "q4" else 96          # 96 does not divide 256: one group
        want = jq.quantize_kernel4(jnp.asarray(w), gs)
        got = q.quantize_kernel4(torch.from_numpy(w), gs)
        assert got["scale4"].shape[-2] == (2 if case == "q4" else 1)
        back = (q.dequantize_kernel4(got), jq.dequantize_kernel4(want))
    assert set(got) == set(want)
    for name in got:
        np.testing.assert_array_equal(got[name].numpy(), _np(want[name]), err_msg=name)
    np.testing.assert_array_equal(back[0].numpy(), np.asarray(back[1]))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_products_match_jax(bits):
    w = _kernel((256, 48), seed=1)
    x = np.random.default_rng(2).normal(size=(3, 5, 256)).astype(np.float32)
    if bits == 8:
        node = jq.quantize_kernel(jnp.asarray(w))
        want = jq.q8_matmul(jnp.asarray(x), node)
        got = q.q8_matmul(torch.from_numpy(x), *(torch.from_numpy(_np(node[k]))
                                                  for k in ("q8", "scale")))
    else:
        node = jq.quantize_kernel4(jnp.asarray(w), 128)
        want = jq.q4_matmul(jnp.asarray(x), node)
        got = q.q4_matmul(torch.from_numpy(x), *(torch.from_numpy(_np(node[k]))
                                                  for k in ("q4", "scale4")))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PRODUCT_TOL)


def _llm_pair(bits, group_size=128):
    """A tiny JAX LLM quantized by the JAX package, the port's quantized
    with the same scheme and loaded from the converted JAX pytree."""
    jcfg = jqwen2.Qwen2Config.tiny()
    params = jq.quantize_llm(jqwen2.init_params(jax.random.PRNGKey(5), jcfg), bits, group_size)
    llm = q.quantize_llm(qwen2.Qwen2Model(qwen2.Qwen2Config.tiny()), bits, group_size)
    llm.load_state_dict(convert.qwen2_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, params, llm.eval()


@pytest.mark.parametrize("bits,group_size", [(8, 128), (4, 32), (4, 48)])
def test_convert_quant_spec_and_dequantize_llm_match_jax(bits, group_size):
    jcfg, params, llm = _llm_pair(bits, group_size)
    assert q.quant_spec(llm) == jq.quant_spec(params)
    name = "q8" if bits == 8 else "q4"
    codes = np.asarray(params["layers"]["up_proj"][name][1])
    assert llm.layers[1].up_proj.bits == bits
    np.testing.assert_array_equal(getattr(llm.layers[1].up_proj, name).numpy(), _np(codes))
    dense = jq.dequantize_llm(params, jnp.float32)
    q.dequantize_llm(llm, torch.float32)
    assert q.quant_spec(llm) is None
    for proj in q.QUANT_TARGETS:
        np.testing.assert_array_equal(
            getattr(llm.layers[0], proj).weight.detach().numpy().T,
            np.asarray(dense["layers"][proj]["kernel"][0]), err_msg=proj)
    with pytest.raises(ValueError, match="4 or 8"):
        q.quantize_llm(llm, 3)


def _tasu_pair(bits):
    flags = dict(ctc_posterior=True, do_psd=True, quantization=True, quant_bits=bits,
                 q4_group_size=32)
    jm = jtasu.model_factory(
        JaxTrainConfig(**flags), JaxModelConfig(llm_path="", encoder_dim=ENC_VOCAB, llm_dim=LLM_DIM),
        rng=jax.random.PRNGKey(0))
    jm.speech_token_id = SPEECH
    pm = tasu.model_factory(TrainConfig(**flags),
                            ModelConfig(encoder_dim=ENC_VOCAB, llm_dim=LLM_DIM), device="cpu")
    pm.load_state_dict(convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params)))
    pm.speech_token_id = SPEECH
    return jm, pm


def _batch(b=3, s=10, a=8):
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 200, size=(b, s)).astype(np.int32)
    ids[:, 3] = SPEECH
    feats = rng.normal(size=(b, a, ENC_INPUT)).astype(np.float32)
    lens = np.array([a, a - 3, 2], np.int32)
    jb = {"input_ids": jnp.asarray(ids), "attention_mask": jnp.ones((b, s), bool),
          "input_features": jnp.asarray(feats), "input_feature_length": jnp.asarray(lens)}
    tb = {"input_ids": torch.from_numpy(ids).long(), "attention_mask": torch.ones(b, s, dtype=bool),
          "input_features": torch.from_numpy(feats),
          "input_feature_length": torch.from_numpy(lens).long()}
    return jb, tb


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_tasu_logits_match_jax(bits):
    """The factories quantize (the port's from its own random weights, then
    overwritten by the JAX codes); the merged prefill's logits agree."""
    jm, pm = _tasu_pair(bits)
    assert q.quant_spec(pm.llm) == jq.quant_spec(jm.params["llm"])
    jb, tb = _batch()
    m = jtasu.prepare_merged(jm, jm.params, jb, None, left_padding=True, generate_mode=True)
    hidden, _ = jqwen2.forward(jm.params["llm"], jm.llm_cfg, m.embeds, m.attention_mask,
                               m.position_ids)
    want = np.asarray(jqwen2.unembed(jm.params["llm"], hidden))
    with torch.no_grad():
        tm = tasu.prepare_merged(pm, tb, left_padding=True, generate_mode=True)
        got_h, _ = pm.llm(tm.embeds, tm.attention_mask, tm.position_ids)
        got = pm.llm.unembed(got_h).numpy()
    valid = np.asarray(m.attention_mask)
    np.testing.assert_allclose(got[valid], want[valid], **LOGIT_TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_checkpoint_import_keeps_the_scheme_as_jax(bits, tmp_path):
    """A dense export imported into a quantized model is re-quantized with
    the model's scheme, to the JAX import's codes; the export of a
    quantized model carries the dequantized kernels, as JAX's does."""
    flags = dict(ctc_posterior=True, do_psd=True)
    mc = JaxModelConfig(llm_path="", encoder_dim=ENC_VOCAB, llm_dim=LLM_DIM)
    src = jtasu.model_factory(JaxTrainConfig(**flags), mc, rng=jax.random.PRNGKey(0))
    path = str(tmp_path / "dense.bin")
    jax_export(src, path)
    quant = dict(flags, quantization=True, quant_bits=bits, q4_group_size=32)
    dst = jtasu.model_factory(JaxTrainConfig(**quant), mc, rng=jax.random.PRNGKey(1))
    jax_import(dst, path, jnp.float32)
    pm = tasu.model_factory(TrainConfig(**quant),
                            ModelConfig(encoder_dim=ENC_VOCAB, llm_dim=LLM_DIM), device="cpu")
    loaded = checkpoint.import_reference_checkpoint(pm, path)
    assert any(k.startswith("llm.") for k in loaded)
    assert q.quant_spec(pm.llm) == (bits, 0 if bits == 8 else 32)
    names = ("q8", "scale") if bits == 8 else ("q4", "scale4")
    for name in names:
        want = np.asarray(dst.params["llm"]["layers"]["gate_proj"][name][1])
        np.testing.assert_array_equal(getattr(pm.llm.layers[1].gate_proj, name).numpy(),
                                      _np(want), err_msg=name)
    # export: dequantized (bf16-rounded) kernels under the HF names
    want_t = jax_export(dst, str(tmp_path / "jax_q.bin"))
    got_t = checkpoint.export_reference_checkpoint(pm, str(tmp_path / "port_q.bin"))
    assert set(got_t) == set(want_t)
    key = "llm.model.layers.0.mlp.down_proj.weight"
    np.testing.assert_array_equal(got_t[key].numpy(), np.asarray(want_t[key]))


def test_int8_cache_windows_at_per_row_offsets_match_jax():
    """Prefill into an int8 cache, then a 3-token window written at per-row
    offsets ([B] cache_index) attending causally over the cache: hidden
    states and the dequantized cache against ``qwen2.forward``."""
    jcfg = jqwen2.Qwen2Config.tiny()
    params = jqwen2.init_params(jax.random.PRNGKey(5), jcfg)
    llm = qwen2.Qwen2Model(qwen2.Qwen2Config.tiny())
    llm.load_state_dict(convert.qwen2_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(1)
    b, s, w, cap = 2, 6, 3, 12
    emb = rng.normal(size=(b, s + w, 64)).astype(np.float32) * 0.5
    mask = np.zeros((b, cap), bool)
    mask[0, :s] = True
    mask[1, 2:s] = True                               # a left-padded row
    pos = np.clip(np.cumsum(mask[:, :s], -1) - 1, 0, None)
    idx = np.array([s, s + 2])                         # per-row write offsets
    win_mask = mask.copy()
    for r in range(b):
        win_mask[r, s:idx[r] + w] = True
    win_pos = (pos[:, -1] + 1)[:, None] + np.arange(w)

    jcache = jqwen2.init_cache(jcfg, b, cap, dtype=jnp.float32, kv_bits=8)
    jh0, jcache = jqwen2.forward(params, jcfg, jnp.asarray(emb[:, :s]), jnp.asarray(mask),
                                 jnp.asarray(pos), cache=jcache, cache_index=0)
    jh1, jcache = jqwen2.forward(params, jcfg, jnp.asarray(emb[:, s:]), jnp.asarray(win_mask),
                                 jnp.asarray(win_pos), cache=jcache,
                                 cache_index=jnp.asarray(idx, jnp.int32))
    tcache = qwen2.init_cache(llm.cfg, b, cap, torch.float32, device="cpu", kv_bits=8)
    with torch.no_grad():
        th0, _ = llm(torch.from_numpy(emb[:, :s]), torch.from_numpy(mask),
                     torch.from_numpy(pos), cache=tcache, cache_index=0)
        th1, _ = llm(torch.from_numpy(emb[:, s:]), torch.from_numpy(win_mask),
                     torch.from_numpy(win_pos), cache=tcache, cache_index=torch.from_numpy(idx))
    valid = mask[:, :s]
    np.testing.assert_allclose(th0.numpy()[valid], np.asarray(jh0)[valid], **LOGIT_TOL)
    np.testing.assert_allclose(th1.numpy(), np.asarray(jh1), **LOGIT_TOL)
    for i, (k8, kscale, v8, vscale) in enumerate(tcache):
        for got, (c8, cs) in (((k8, kscale), ("k8", "kscale")), ((v8, vscale), ("v8", "vscale"))):
            want = jq.dequantize_kv(jcache[c8][i], jcache[cs][i], jnp.float32)
            np.testing.assert_allclose(q.dequantize_kv(*got, torch.float32).numpy(),
                                       np.asarray(want), atol=2e-2, rtol=0)
    with pytest.raises(ValueError, match="kv_bits"):
        qwen2.init_cache(llm.cfg, 1, 4, torch.float32, device="cpu", kv_bits=4)
