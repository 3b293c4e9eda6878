"""PyTorch port: PEFT (LoRA, QLoRA, prefix tuning, llama-adapter) against
the JAX package (CPU, fp32, plain versions of the kernels).

Tiny audio-TASU models (2 LLM layers, 64 wide) with each adapter, built by
the JAX factory, their adapters given random values (LoRA's B and the
gates start at zero), and converted leaf by leaf into the port's model:

* the training forward's loss and the greedy tokens (prefix tuning: the
  prefix prepended to the KV cache's keys at every step) equal JAX's;
* the port's init laws (shapes, bounds, zero B and gates, the frozen 0/1
  layer mask as a buffer);
* ``merge_lora`` on fp32, int8 and int4 bases, ``export_peft_adapters``
  (tensors and ``adapter_config.json``) and ``import_peft_adapters``
  (alpha / r read back) against JAX's.

Training with PEFT is in tests/test_torch_peft_train.py.  Tolerances
(fp32, the packages sum in different orders): losses and forward values
1e-5, merged bf16 kernels one bf16 rounding (2^-8 relative).  About 45 s
on one CPU, a third of it the JAX package's first compiles.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_slm_tpu.config import ModelConfig as JaxModelConfig
from ps_slm_tpu.config import PeftConfig as JaxPeftConfig
from ps_slm_tpu.config import TrainConfig as JaxTrainConfig
from ps_slm_tpu.inference.generate import generate as jax_generate
from ps_slm_tpu.models import lora as jlora
from ps_slm_tpu.models import tasu as jtasu
from ps_slm_tpu.training import checkpoint as jckpt
from ps_slm_tpu_torch import convert
from ps_slm_tpu_torch.config import ModelConfig, PeftConfig, TrainConfig
from ps_slm_tpu_torch.inference.generate import generate
from ps_slm_tpu_torch.models import lora, tasu
from ps_slm_tpu_torch.training import checkpoint as ckpt

SPEECH = 250
ENC_VOCAB, ENC_INPUT, LLM_DIM = 11, 24, 64
TOL = dict(atol=1e-5, rtol=1e-5)
HALF_AUDIO = dict(ctc_posterior=True, do_psd=True, freeze_llm=True, freeze_encoder=True)
PEFT = dict(r=4, lora_alpha=8, num_virtual_tokens=3, adapter_len=3, adapter_layers=1)
METHODS = {   # name -> (peft_method, train flags)
    "lora": ("lora", {}),
    "qlora8": ("lora", dict(quantization=True, quant_bits=8)),
    "qlora4": ("lora", dict(quantization=True, quant_bits=4, q4_group_size=32)),
    "prefix": ("prefix", {}),
    "llama_adapter": ("llama_adapter", {}),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(params, seed=1):
    """LoRA's B and the gates start at zero: give every adapter leaf
    random values so each one acts."""
    rng = np.random.default_rng(seed)
    layers = dict(params["llm"]["layers"])
    for name, node in layers.items():
        if isinstance(node, dict) and "lora_b" in node:
            node = dict(node)
            node["lora_b"] = jnp.asarray(rng.normal(size=node["lora_b"].shape) * 0.2, jnp.float32)
            layers[name] = node
    if "adaption_gate" in layers:
        layers["adaption_gate"] = jnp.asarray(rng.normal(size=layers["adaption_gate"].shape),
                                              jnp.float32)
    params = dict(params)
    params["llm"] = dict(params["llm"], layers=layers)
    return params


def _pair(name, dropout=0.0, **train):
    method, extra = METHODS[name]
    flags = dict(HALF_AUDIO, use_peft=True, **extra, **train)
    peft = dict(PEFT, peft_method=method, lora_dropout=dropout)
    jtc = JaxTrainConfig(**flags, peft_config=JaxPeftConfig(**peft))
    jm = jtasu.model_factory(
        jtc, JaxModelConfig(llm_path="", encoder_dim=ENC_VOCAB, llm_dim=LLM_DIM),
        rng=jax.random.PRNGKey(0))
    jm.params = _perturb(jm.params)
    jm.speech_token_id = SPEECH
    tc = TrainConfig(**flags, peft_config=PeftConfig(**peft))
    pm = tasu.model_factory(tc, ModelConfig(encoder_dim=ENC_VOCAB, llm_dim=LLM_DIM), device="cpu")
    pm.load_state_dict(convert.from_jax_params(_np_tree(jm.params)))
    pm.speech_token_id = SPEECH
    return jtc, jm, tc, pm


def _batch(b=3, s=10, a=12, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 200, size=(b, s)).astype(np.int32)
    ids[:, 3] = SPEECH
    mask = np.ones((b, s), bool)
    mask[-1, -1] = False
    labels = np.where(mask, ids, -100).astype(np.int32)
    labels[:, :4] = -100
    np_batch = {
        "input_ids": ids, "attention_mask": mask, "labels": labels,
        "input_features": rng.normal(size=(b, a, ENC_INPUT)).astype(np.float32),
        "input_feature_length": np.array([a, a - 3, 4][:b], np.int32),
    }
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    for k in ("input_ids", "labels", "input_feature_length"):
        tb[k] = tb[k].long()
    return jb, tb


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               err_msg=msg, **tol)


# ----------------------------------------------------------------------------
# forward and decode
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(METHODS))
def test_forward_and_greedy_decode_equal_jax(name):
    _, jm, _, pm = _pair(name)
    jb, tb = _batch()
    want = jax.jit(lambda p: jtasu.forward(jm, p, jb, None, train=False)[0])(jm.params)
    with torch.no_grad():
        got, _ = tasu.forward(pm, tb, train=False)
    _close(got, want)
    gen = {k: v for k, v in tb.items() if k != "labels"}
    jgen = {k: v for k, v in jb.items() if k != "labels"}
    kw = dict(num_beams=1, max_new_tokens=6, eos_token_id=9)
    want_ids = np.asarray(jax_generate(jm, jm.params, jgen, **kw))
    np.testing.assert_array_equal(generate(pm, gen, device="cpu", **kw).numpy(), want_ids)


def test_prefix_beam_decode_equals_jax():
    """Beam search tiles the cache; the prefix is re-read every step."""
    _, jm, _, pm = _pair("prefix")
    jb, tb = _batch()
    kw = dict(num_beams=2, max_new_tokens=5, eos_token_id=9)
    want = np.asarray(jax_generate(jm, jm.params, {k: v for k, v in jb.items() if k != "labels"},
                                   **kw))
    got = generate(pm, {k: v for k, v in tb.items() if k != "labels"}, device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_laws():
    for name in ("lora", "prefix", "llama_adapter"):
        method, _ = METHODS[name]
        tc = TrainConfig(**HALF_AUDIO, use_peft=True,
                         peft_config=PeftConfig(**dict(PEFT, r=8, peft_method=method)))
        pm = tasu.model_factory(tc, ModelConfig(encoder_dim=ENC_VOCAB, llm_dim=LLM_DIM),
                                device="cpu")
        layers = pm.llm.layers
        if name == "lora":
            for proj in lora.LORA_TARGETS:
                lin = getattr(layers[1], proj)
                assert lin.lora_a.shape == (lin.in_features, 8)
                assert lin.lora_b.shape == (8, lin.out_features) and not lin.lora_b.any()
                assert lin.lora_a.abs().max() <= 1 / lin.in_features ** 0.5
                assert float(lin.lora_scale) == 1.0 and "lora_scale" in dict(lin.named_buffers())
        elif name == "prefix":
            pk = torch.stack([layer.prefix_k for layer in layers])
            assert pk.shape == (2, 3, 2, 16)
            assert 0.1 < float(pk.std()) < 0.5          # N(0, 1 / head_dim): std 0.25
        else:
            assert layers[0].adaption_prompt.shape == (3, LLM_DIM)
            assert [float(layer.adaption_mask) for layer in layers] == [0.0, 1.0]
            assert all(float(layer.adaption_gate) == 0.0 for layer in layers)
            assert "adaption_mask" in dict(layers[0].named_buffers())
            assert "adaption_mask" not in dict(layers[0].named_parameters())
        trained = tasu.trainable_mask(pm, tc)
        leaves = {n.rpartition(".")[2] for n in trained if n.startswith("llm.")}
        assert leaves == {"lora": {"lora_a", "lora_b"}, "prefix": {"prefix_k", "prefix_v"},
                          "llama_adapter": {"adaption_prompt", "adaption_gate"}}[name]
        emb = TrainConfig(**{**tc.__dict__, "use_emb": True})
        assert "llm.embed_tokens.weight" in tasu.trainable_mask(pm, emb)


# ----------------------------------------------------------------------------
# merge, export, import
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["lora", "qlora8", "qlora4"])
def test_merge_lora_equals_jax(name):
    _, jm, _, pm = _pair(name)
    want = jlora.merge_lora(jm.params["llm"])["layers"]
    got = lora.merge_lora(pm.llm.state_dict())
    assert not any(k.endswith(("lora_a", "lora_b", "lora_scale", "q8", "q4")) for k in got)
    tol = TOL if name == "lora" else dict(atol=1e-6, rtol=2 ** -8)
    for proj in lora.LORA_TARGETS:
        kernel = np.asarray(want[proj]["kernel"], np.float32)
        for i in range(2):
            w = got[f"layers.{i}.{proj}.weight"]
            assert w.dtype == (torch.float32 if name == "lora" else torch.bfloat16)
            _close(w.float().numpy(), kernel[i].T, tol, f"{proj} {i}")


@pytest.mark.parametrize("name", ["lora", "prefix", "llama_adapter"])
def test_export_import_adapters_equal_jax(name, tmp_path):
    _, jm, tc, pm = _pair(name)
    want = jckpt.export_peft_adapters(jm, str(tmp_path / "jax"))
    got = ckpt.export_peft_adapters(pm, str(tmp_path / "port"))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].numpy(), want[k], TOL, k)
    configs = [json.loads((tmp_path / side / "adapter_config.json").read_text())
               for side in ("jax", "port")]
    assert configs[0] == configs[1]
    saved = torch.load(tmp_path / "port" / "adapter_model.bin", weights_only=True)
    assert sorted(saved) == sorted(got)
    # a fresh model takes the JAX export back, alpha / r included
    if name == "lora":
        cfg = json.loads((tmp_path / "jax" / "adapter_config.json").read_text())
        cfg["lora_alpha"] = 2
        (tmp_path / "jax" / "adapter_config.json").write_text(json.dumps(cfg))
        jckpt.import_peft_adapters(jm, str(tmp_path / "jax"))
    fresh = tasu.model_factory(tc, ModelConfig(encoder_dim=ENC_VOCAB, llm_dim=LLM_DIM),
                               device="cpu", generator=torch.Generator().manual_seed(5))
    loaded = ckpt.import_peft_adapters(fresh, str(tmp_path / "jax"))
    assert sorted(loaded) == sorted(want)
    want_sd = convert.qwen2_state_dict(_np_tree(jm.params["llm"]))
    fresh_sd = fresh.llm.state_dict()
    adapters = [k for k in fresh_sd if k.rpartition(".")[2] in ckpt._ADAPTER_STATE
                # llama-adapter exports only the adapted layers (layer 1 here)
                and not (name == "llama_adapter" and k.startswith("layers.0.adaption_"))]
    assert adapters
    for k in adapters:
        _close(fresh_sd[k].numpy(), want_sd[k].numpy(), TOL, k)
