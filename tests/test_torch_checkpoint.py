"""PyTorch port: the checkpoint loaders against the JAX package's.

Files the JAX package (or ``safetensors.numpy``) writes are read by the
port into tensors bit-equal to ``convert`` of the JAX-loaded params: the
HF Qwen2 safetensors directory, the funasr SenseVoiceSmall directory
(``tools/asset_day.py::_export_funasr_dir``) and the reference
``pytorch_model.bin`` in both directions.  The port's safetensors reader
is held bit-equal to ``safetensors.numpy.load_file``.  A checkpoint that
holds part of a module raises ``KeyError``.
"""

import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import safetensors.numpy
import torch

from ps_slm_tpu.config import ModelConfig as JaxModelConfig
from ps_slm_tpu.config import TrainConfig as JaxTrainConfig
from ps_slm_tpu.models import qwen2 as jqwen2
from ps_slm_tpu.models import sensevoice as jsv
from ps_slm_tpu.models import tasu as jtasu
from ps_slm_tpu.tools.asset_day import _export_funasr_dir
from ps_slm_tpu.training import checkpoint as jckpt
from ps_slm_tpu_torch import convert
from ps_slm_tpu_torch.config import ModelConfig, TrainConfig
from ps_slm_tpu_torch.models import qwen2, tasu
from ps_slm_tpu_torch.training import checkpoint as ckpt

FLAGS = dict(ctc_posterior=True, do_psd=True)
ENC_OVER = {"input_size": 560}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def _as_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def test_safetensors_reader_is_bit_equal(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "a_f32": rng.normal(size=(3, 5)).astype(np.float32),
        "b_bf16": rng.normal(size=(7,)).astype(ml_dtypes.bfloat16),   # odd byte count
        "c_f16": rng.normal(size=(2, 3, 3)).astype(np.float16),
        "d_i64": rng.integers(-2 ** 40, 2 ** 40, size=(4,)).astype(np.int64),
        "e_scalar": np.asarray(3.5, np.float32),
        "f_empty": np.zeros((0, 4), np.float32),
    }
    path = str(tmp_path / "x.safetensors")
    safetensors.numpy.save_file(tensors, path, metadata={"format": "pt"})
    got = qwen2.read_safetensors(path)
    want = safetensors.numpy.load_file(path)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        t = _as_torch(w)
        assert got[k].dtype == t.dtype and tuple(got[k].shape) == w.shape, k
        assert torch.equal(got[k], t), k


def _hf_dir(tmp_path, tie, dtype, bias=True):
    """An HF Qwen2 directory written with ``safetensors.numpy``, from the
    JAX init of a tiny config, in ``dtype`` (numpy)."""
    cfg = jqwen2.Qwen2Config.tiny(tie_word_embeddings=tie)
    params = jqwen2.init_params(jax.random.PRNGKey(1), cfg)
    hf = {k: (np.asarray(v) + (0.01 if k.endswith("bias") else 0.0)).astype(dtype)
          for k, v in jqwen2.params_to_hf(params, cfg).items()}
    if not bias:
        hf = {k: v for k, v in hf.items() if not k.endswith("bias")}
    d = tmp_path / f"llm_{tie}_{np.dtype(dtype).name}_{bias}"
    d.mkdir()
    # two shards, as large checkpoints come
    keys = sorted(hf)
    safetensors.numpy.save_file({k: hf[k] for k in keys[::2]}, str(d / "model-1.safetensors"))
    safetensors.numpy.save_file({k: hf[k] for k in keys[1::2]}, str(d / "model-2.safetensors"))
    (d / "config.json").write_text(json.dumps({
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads, "rope_theta": cfg.rope_theta,
        "tie_word_embeddings": tie}))
    return str(d)


@pytest.mark.parametrize("tie,dtype", [(True, ml_dtypes.bfloat16), (False, np.float32),
                                       (True, np.float16)])
def test_hf_checkpoint_loads_bit_equal_to_jax(tmp_path, tie, dtype):
    path = _hf_dir(tmp_path, tie, dtype)
    state, cfg = qwen2.load_hf_checkpoint(path)
    jparams, jcfg = jqwen2.load_hf_checkpoint(path, dtype=jax.numpy.float32)
    assert cfg.tie_word_embeddings == jcfg.tie_word_embeddings == tie
    assert (cfg.vocab_size, cfg.head_dim, cfg.num_hidden_layers) == (
        jcfg.vocab_size, jcfg.head_dim, jcfg.num_hidden_layers)
    # tensors stay in the file's dtype; cast to fp32 they equal the JAX load
    assert all(v.dtype == _as_torch(np.zeros(1, dtype)).dtype for v in state.values())
    _assert_state_equal({k: v.float() for k, v in state.items()},
                        convert.qwen2_state_dict(_np(jparams)))


def test_hf_checkpoint_without_biases(tmp_path):
    path = _hf_dir(tmp_path, True, np.float32, bias=False)
    state, cfg = qwen2.load_hf_checkpoint(path)
    jparams, _ = jqwen2.load_hf_checkpoint(path, dtype=jax.numpy.float32)
    assert not cfg.attention_bias
    _assert_state_equal(state, convert.qwen2_state_dict(_np(jparams)))
    llm = qwen2.Qwen2Model(cfg)
    llm.load_state_dict(state)


def test_funasr_encoder_loads_bit_equal_to_jax(tmp_path):
    cfg = jsv.SenseVoiceConfig.tiny(**ENC_OVER)
    params = jsv.init_params(jax.random.PRNGKey(2), cfg)
    path = str(tmp_path / "SenseVoiceSmall")
    _export_funasr_dir(path, params, cfg)
    state, pcfg = ckpt.load_funasr_encoder(path)
    jparams, jcfg = jckpt.load_funasr_encoder(path)
    assert (pcfg.input_size, pcfg.output_size, pcfg.num_blocks, pcfg.tp_blocks,
            pcfg.vocab_size) == (jcfg.input_size, jcfg.output_size, jcfg.num_blocks,
                                 jcfg.tp_blocks, jcfg.vocab_size)
    _assert_state_equal(state, convert.encoder_state_dict(_np(jparams)))
    # the minimal reader of funasr's config.yaml equals PyYAML's
    assert ckpt._parse_encoder_yaml(os.path.join(path, "config.yaml")) == \
        jckpt._parse_encoder_yaml(os.path.join(path, "config.yaml"))


def test_encoder_yaml_reader_without_pyyaml(tmp_path, monkeypatch):
    import sys

    path = tmp_path / "config.yaml"
    path.write_text("# funasr\ninput_size: 560\nvocab_size: 25055\nencoder_conf:\n"
                    "  output_size: 512\n  attention_heads: 4\n  normalize_before: true\n"
                    "frontend_conf:\n  fs: 16000\n")
    with_yaml = ckpt._parse_encoder_yaml(str(path))
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert ckpt._parse_encoder_yaml(str(path)) == with_yaml == {
        "output_size": 512, "attention_heads": 4, "normalize_before": True,
        "input_size": 560, "vocab_size": 25055}


def _jax_model(tie=True):
    return jtasu.model_factory(
        JaxTrainConfig(**FLAGS),
        JaxModelConfig(encoder_dim=11, llm_dim=64, encoder_config_overrides=ENC_OVER,
                       llm_config_overrides={"tie_word_embeddings": tie}),
        rng=jax.random.PRNGKey(3))


def _port_model(tie=True, seed=9, dtype=torch.float32):
    return tasu.model_factory(
        TrainConfig(**FLAGS, seed=seed),
        ModelConfig(encoder_dim=11, llm_dim=64, encoder_config_overrides=ENC_OVER,
                    llm_config_overrides={"tie_word_embeddings": tie}),
        device="cpu", dtype=dtype)


@pytest.mark.parametrize("tie", [True, False])
def test_reference_checkpoint_from_jax_loads_bit_equal(tmp_path, tie):
    jm = _jax_model(tie)
    path = str(tmp_path / "pytorch_model.bin")
    jckpt.export_reference_checkpoint(jm, path)
    pm = _port_model(tie)
    loaded = ckpt.import_reference_checkpoint(pm, path)
    jloaded = jckpt.import_reference_checkpoint(_jax_model(tie), path)
    assert sorted(loaded) == sorted(jloaded)
    _assert_state_equal(pm.state_dict(), convert.from_jax_params(_np(jm.params)))


def test_reference_checkpoint_round_trip_through_jax(tmp_path):
    pm = _port_model(seed=4)
    path = str(tmp_path / "port.bin")
    written = ckpt.export_reference_checkpoint(pm, path)
    assert all(v.dtype == torch.float32 for v in written.values())
    jm = _jax_model()
    jckpt.import_reference_checkpoint(jm, path)
    _assert_state_equal(convert.from_jax_params(_np(jm.params)), pm.state_dict())
    # projector-only (frozen modules left out), into a bf16 model: cast once
    bf = _port_model(seed=5, dtype=torch.bfloat16)
    before = {k: v.clone() for k, v in bf.state_dict().items()}
    path = str(tmp_path / "proj.bin")
    ckpt.export_reference_checkpoint(pm, path, exclude=("llm", "encoder"))
    loaded = ckpt.import_reference_checkpoint(bf, path)
    assert sorted(loaded) == sorted(jckpt.import_reference_checkpoint(_jax_model(), path))
    for k, v in bf.state_dict().items():
        want = pm.state_dict()[k].to(torch.bfloat16) if k.startswith("projector.") else before[k]
        assert torch.equal(v, want), k


@pytest.mark.parametrize("module,drop", [
    ("llm", "llm.model.layers.1.mlp.up_proj.weight"),
    ("encoder", "encoder.encoder.encoders.1.norm1.weight"),
])
def test_partial_module_raises_key_error(module, drop):
    pm = _port_model()
    tensors = ckpt.export_reference_checkpoint(pm, "")
    del tensors[drop]
    target = _port_model(seed=6)
    before = {k: v.clone() for k, v in target.state_dict().items()}
    with pytest.raises(KeyError, match=f"partial {module} checkpoint"):
        ckpt.import_reference_checkpoint(target, tensors)
    with pytest.raises(KeyError, match=f"partial {module} checkpoint"):
        jckpt.import_reference_checkpoint(_jax_model(), {k: v.numpy() for k, v in tensors.items()})
    for k, v in target.state_dict().items():
        if k.startswith(module):
            assert torch.equal(v, before[k]), k


def test_factory_loads_the_asset_directories(tmp_path):
    """model_factory with llm_path and encoder_path: every parameter equals
    the file's tensor cast once to the model's dtype (bf16 safetensors as
    they are, the fp32 model.pt rounded once)."""
    llm_path = _hf_dir(tmp_path, True, ml_dtypes.bfloat16)
    cfg = jsv.SenseVoiceConfig.tiny(**ENC_OVER)
    enc_path = str(tmp_path / "enc")
    _export_funasr_dir(enc_path, jsv.init_params(jax.random.PRNGKey(2), cfg), cfg)
    mc = ModelConfig(llm_path=llm_path, encoder_path=enc_path, encoder_dim=11, llm_dim=64)
    model = tasu.model_factory(TrainConfig(**FLAGS), mc, device="cpu", dtype=torch.bfloat16)
    assert set(model.load_seconds) == {"llm", "encoder"}
    llm_state, _ = qwen2.load_hf_checkpoint(llm_path)
    enc_state, _ = ckpt.load_funasr_encoder(enc_path)
    for name, state in (("llm", llm_state), ("encoder", enc_state)):
        got = getattr(model, name).state_dict()
        for k, v in state.items():
            assert torch.equal(got[k], v.to(torch.bfloat16)), k


def test_factory_raises_on_what_is_not_ported(tmp_path):
    """ctc_linear, which raised until its ROADMAP.md item landed, loads a
    pretrained CTC head into the simple_linear projector now, and refuses
    any other projector."""
    path = str(tmp_path / "ctc.pt")
    head = {"ctc_head.weight": torch.randn(64, 22), "ctc_head.bias": torch.randn(64)}
    torch.save(head, path)
    mc = ModelConfig(encoder_dim=11, llm_dim=64, ctc_linear=path)
    with pytest.raises(ValueError, match="simple_linear"):
        tasu.model_factory(TrainConfig(**FLAGS), mc, device="cpu")
    mc = ModelConfig(encoder_dim=11, llm_dim=64, ctc_linear=path, encoder_projector="simple_linear",
                     encoder_projector_ds_rate=2)
    model = tasu.model_factory(TrainConfig(**FLAGS), mc, device="cpu")
    assert torch.equal(model.projector.map.weight, head["ctc_head.weight"])
    assert torch.equal(model.projector.map.bias, head["ctc_head.bias"])
