"""PyTorch port: import hygiene, device policy and the C interface.

The port imports neither JAX nor the JAX package; its entry points run on
CUDA unless the caller asks for the CPU; its kernel wrappers take the plain
versions only for CPU tensors.  The ctypes signatures are held against the
``extern "C"`` entry points of ``csrc/`` here, since nvcc only runs on the
card's machine.
"""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ps_slm_tpu_torch import _build
from ps_slm_tpu_torch.config import ModelConfig, TrainConfig
from ps_slm_tpu_torch.inference.generate import generate
from ps_slm_tpu_torch.models import qwen2, tasu
from ps_slm_tpu_torch.ops import flash_attention, norms
from ps_slm_tpu_torch.training import step as train_step
from ps_slm_tpu_torch.training import train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "ps_slm_tpu_torch")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "ps_slm_tpu")


# packages the H100 machine lacks: the port reads safetensors, tokenizes and
# decodes the BPE models with its own code
ABSENT_ON_CARD = ("safetensors", "transformers", "sentencepiece", "regex")


# the serving recipe's modules (scripts/decode_serving.sh), CTC, standalone
# SenseVoice and the metric, imported too
SERVING_MODULES = tuple(f"ps_slm_tpu_torch.{m}" for m in (
    "models.quantization", "inference.speculative", "inference.continuous",
    "inference.continuous_spec", "inference.continuous_beam",
    "ops.ctc", "models.sensevoice_asr", "models.projector", "utils.metric",
))


def _port_files():
    for dirpath, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ps_slm_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'ps_slm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"('jax', 'jaxlib', 'ps_slm_tpu') + {ABSENT_ON_CARD!r})\n"
        f"bad += sorted(set({SERVING_MODULES!r}) - set(sys.modules))\n"
        "print(len([m for m in sys.modules if m.startswith('ps_slm_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) >= 15  # every module was imported


def test_no_jax_import_in_port_sources():
    offenders = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            offenders += [f"{path}: {n}" for n in names
                          if _forbidden(n) or n.split(".")[0] in ABSENT_ON_CARD]
    assert not offenders, offenders


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    tc, mc = TrainConfig(ctc_posterior=True, do_psd=True), ModelConfig(encoder_dim=11, llm_dim=64)
    with pytest.raises(RuntimeError, match="cuda"):
        tasu.model_factory(tc, mc)
    with pytest.raises(RuntimeError, match="cuda"):
        qwen2.init_cache(qwen2.Qwen2Config.tiny(), 1, 4, torch.float32)
    model = tasu.model_factory(tc, mc, device="cpu")
    batch = {"input_ids": torch.zeros(1, 4, dtype=torch.long)}
    with pytest.raises(RuntimeError, match="cuda"):
        generate(model, batch, eos_token_id=0, num_beams=1)


def test_decode_cli_defaults_to_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    import inspect

    from ps_slm_tpu_torch.cli import decode

    assert inspect.signature(decode.main).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        decode.main([f"decode_log={tmp_path}/x", "++train_config.ctc_posterior=true"])
    r = subprocess.run(
        [sys.executable, "-m", "ps_slm_tpu_torch.cli.decode", f"decode_log={tmp_path}/y",
         "++train_config.ctc_posterior=true", f"++log_config.log_file={tmp_path}/log"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0 and "torch.cuda.is_available() is False" in r.stderr
    assert not os.path.exists(f"{tmp_path}/y_pred")


def test_serving_entry_points_default_to_cuda_and_raise_without_it():
    """The slot pools (and the pool factory) default to the card and raise
    without it; generate refuses the knobs that would change the tokens
    of draft-verified decoding."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    import inspect
    from types import SimpleNamespace

    from ps_slm_tpu_torch import inference
    from ps_slm_tpu_torch.config import DataConfig
    from ps_slm_tpu_torch.inference import continuous, continuous_beam, continuous_spec

    tc = TrainConfig(ctc_posterior=True, do_psd=True, num_beams=1)
    model = tasu.model_factory(tc, ModelConfig(encoder_dim=11, llm_dim=64), device="cpu")
    for cls in (continuous.ContinuousGreedyDecoder, continuous_spec.ContinuousSpeculativeDecoder,
                continuous_beam.ContinuousBeamDecoder):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
        with pytest.raises(RuntimeError, match="cuda"):
            cls(model, prefill_len=8, eos_token_id=0)
    assert inspect.signature(inference.make_pool_decoder).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        inference.make_pool_decoder(model, tc, DataConfig(), eos_token_id=0)
    batch = {"input_ids": torch.zeros(1, 4, dtype=torch.long)}
    drafts = dict(draft_ids=torch.zeros(1, 2, dtype=torch.long), draft_lens=torch.ones(1))
    for kw in (dict(do_sample=True), dict(temperature=0.5), dict(repetition_penalty=1.2),
               dict(min_length=3)):
        with pytest.raises(ValueError, match="bit-identical to plain greedy"):
            generate(model, batch, eos_token_id=0, num_beams=1, device="cpu", **kw, **drafts)
    knobs = SimpleNamespace(repetition_penalty=1.0, do_sample=False, min_length=1,
                            speculative_ctc=True, spec_window=1, num_beams=1,
                            stream_partials=False)
    with pytest.raises(ValueError, match="spec_window"):
        inference.validate_pool_decode_knobs(knobs, "speculative_ctc")


def test_decode_slice_not_ported_names_its_roadmap_item(tmp_path):
    """The whisper front end, which raised until the parallelism slice,
    collates a [B, 3000, 128] mel batch; ctc_linear refuses a projector
    other than simple_linear; HF transformers tokenizers raise
    ImportError."""
    from ps_slm_tpu_torch.config import DataConfig, FbankConfig
    from ps_slm_tpu_torch.data import dataset, tokenizer
    from ps_slm_tpu_torch.ops import fbank

    tc = TrainConfig(ctc_posterior=True, do_psd=True)
    with pytest.raises(ValueError, match="simple_linear"):
        tasu.model_factory(tc, ModelConfig(encoder_dim=11, llm_dim=64, ctc_linear="c.pt"),
                           device="cpu")
    samples = [dataset.Sample("k", np.zeros(3, np.int32), None, 3, np.zeros(1600, np.float32),
                              3000, np.zeros(0, np.int32), "t", "t", "ASR", 1600)]
    coll = dataset.Collator(tokenizer.StubTokenizer(), DataConfig(encoder="whisper"), True)
    batch = coll(samples)
    assert batch["input_features"].shape == (1, 3000, 128) and "waveform" not in batch
    assert list(batch["input_feature_length"]) == [3000]
    out, _ = fbank.frontend(torch.zeros(1, 800), torch.tensor([800]), cfg=FbankConfig(),
                            train=True, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all()
    (tmp_path / "tokenizer.json").write_text("{}")
    with pytest.raises(ImportError, match="transformers"):
        tokenizer.load_tokenizer(str(tmp_path))


def test_train_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    tc = TrainConfig(ctc_posterior=True, do_psd=True, freeze_llm=True, freeze_encoder=True)
    mc = ModelConfig(encoder_dim=11, llm_dim=64)
    with pytest.raises(RuntimeError, match="cuda"):
        tasu.model_factory(tc, mc)
    model = tasu.model_factory(tc, mc, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        train_step.make_train_step(model, tc)
    with pytest.raises(RuntimeError, match="cuda"):
        train_step.make_eval_step(model)
    assert callable(train_step.make_train_step(model, tc, device="cpu"))
    import inspect

    from ps_slm_tpu_torch.cli import finetune

    assert inspect.signature(finetune.main).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        finetune.main(["++train_config.ctc_posterior=true"])


def test_training_options_not_ported_name_their_roadmap_item(tmp_path, monkeypatch):
    """remat, gradient accumulation, PEFT and training over a quantized
    LLM build a model and a step; the mesh options, which raised until the
    parallelism slice, parse, and the finetune CLI joins a process group
    from PS_COORDINATOR / PS_NUM_HOSTS / PS_HOST_ID (here a group of one)
    instead of raising."""
    import torch.distributed as dist

    from ps_slm_tpu_torch.cli import finetune
    from ps_slm_tpu_torch.config import RunConfig, parse_cli
    from ps_slm_tpu_torch.parallel import launch, mesh

    mc = ModelConfig(encoder_dim=11, llm_dim=64)
    tc = TrainConfig(ctc_posterior=True, do_psd=True, freeze_llm=True, freeze_encoder=True)
    options = TrainConfig(**{**tc.__dict__, "remat": True, "gradient_accumulation_steps": 2})
    model = tasu.model_factory(options, mc, device="cpu")
    step = train_step.make_train_step(model, options, device="cpu")
    assert model.remat and step.accum.every_k == 2
    qlora = TrainConfig(**{**tc.__dict__, "use_peft": True, "quantization": True})
    peft_model = tasu.model_factory(qlora, mc, device="cpu")
    trained = tasu.trainable_mask(peft_model, qlora)
    assert sorted({n.rpartition(".")[2] for n in trained if n.startswith("llm.")}) == [
        "lora_a", "lora_b"]
    all_frozen = TrainConfig(**{**tc.__dict__, "freeze_projector": True})
    with pytest.raises(ValueError, match="no trainable"):
        train_state.build_optimizer([], all_frozen)
    cfg = parse_cli(['++train_config.mesh_shape={"data": 2}', "++train_config.fsdp_min_size=1",
                     "++train_config.pp_microbatches=4"], RunConfig())
    assert (cfg.train_config.mesh_shape, cfg.train_config.fsdp_min_size,
            cfg.train_config.pp_microbatches) == ({"data": 2}, 1, 4)
    assert not hasattr(finetune, "check_ported")
    assert mesh.init_distributed("cpu") == (1, 0) and not dist.is_initialized()
    with monkeypatch.context() as m:
        m.setenv("PS_NUM_HOSTS", "2")
        with pytest.raises(ValueError, match="PS_COORDINATOR"):
            mesh.init_distributed("cpu")
    with monkeypatch.context() as m:
        m.setenv("PS_COORDINATOR", f"localhost:{launch.free_port()}")
        m.setenv("PS_NUM_HOSTS", "1")
        m.setenv("PS_HOST_ID", "0")
        try:
            assert mesh.init_distributed("cpu") == (1, 0)
            assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        finally:
            dist.destroy_process_group()


@pytest.mark.parametrize("what,item", [
    ("voca_trans", "Long tail"), ("cross_attn", "Long tail"), ("raw_features", "Long tail"),
])
def test_generate_rejects_what_is_not_ported(what, item):
    """voca_trans, the cross-attention projector and the raw-feature
    baseline, which raised until their ROADMAP.md item landed, build and
    generate now; the port's only raise left that names ROADMAP.md queue 1
    is ``tools/goldens.py``'s ``capture``, under ``item``."""
    mc = {"voca_trans": ModelConfig(encoder_projector="simple_linear", encoder_dim=16,
                                    llm_dim=256, encoder_projector_ds_rate=2),
          "cross_attn": ModelConfig(encoder_projector="cross-attention", encoder_dim=11,
                                    llm_dim=64, ca_heads=4),
          "raw_features": ModelConfig(encoder_projector="linear", encoder_dim=16, llm_dim=64)}
    flags = {"voca_trans": dict(ctc_posterior=True, voca_trans=True, do_psd=True),
             "cross_attn": dict(ctc_posterior=True, cross_attn=True),
             "raw_features": dict(ctc_posterior=False)}
    model = tasu.model_factory(TrainConfig(**flags[what]), mc[what], device="cpu")
    g = torch.Generator().manual_seed(0)
    batch = {"input_ids": torch.tensor([[5, 0, 7]]), "attention_mask": torch.ones(1, 3, dtype=torch.bool),
             "input_features": torch.randn(1, 6, 24, generator=g),
             "input_feature_length": torch.tensor([6])}
    out = generate(model, batch, eos_token_id=1, num_beams=1, max_new_tokens=3, device="cpu")
    assert out.shape == (1, 3)
    raises = subprocess.run(["grep", "-rn", "ROADMAP.md queue 1", PACKAGE], capture_output=True,
                            text=True).stdout.splitlines()
    assert raises and all(f"'{item}'" in r for r in raises), raises
    assert {r.split(":")[0] for r in raises} == {os.path.join(PACKAGE, "tools", "goldens.py")}


def test_wrappers_raise_off_cpu_and_cuda():
    x = torch.zeros(2, 128, device="meta")
    w = torch.ones(128, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        norms.layer_norm_fwd(x, w, w)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        norms.rms_norm_fwd(x, w)
    q = torch.zeros(1, 2, 1, 128, device="meta")
    win = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_attention.flash_attention_fwd(q, q, q, win, win, causal=True, scale=1.0)


def test_backward_wrappers_raise_off_cpu_and_cuda():
    x = torch.zeros(2, 128, device="meta")
    w = torch.ones(128, device="meta")
    stat = torch.zeros(2, 1, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        norms.layer_norm_bwd(x, w, stat, stat, x)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        norms.rms_norm_bwd(x, w, stat, x)
    q = torch.zeros(1, 2, 1, 128, device="meta")
    lse = torch.zeros(1, 1, 2, device="meta")
    win = torch.zeros(1, dtype=torch.int32, device="meta")
    args = (q, q, q, win, win, q, lse, q, lse)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_attention.flash_attention_dq(*args, causal=True, scale=1.0)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_attention.flash_attention_dkv(*args, causal=True, scale=1.0)


def test_ctypes_signatures_match_c_entry_points():
    c_entries = {}
    for fname in os.listdir(_build.CSRC):
        with open(os.path.join(_build.CSRC, fname)) as f:
            src = f.read()
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
            c_entries[name] = len(args.split(","))
    declared = {
        **norms._SIGNATURES, **norms._LN_BWD_SIGNATURES, **flash_attention._SIGNATURES,
        **flash_attention._BWD_SIGNATURES,
    }
    assert {k: len(v) for k, v in declared.items()} == c_entries
    assert {"ps_flash_bwd_dq", "ps_flash_bwd_dkv", "ps_layer_norm_bwd",
            "ps_rms_norm_bwd"} <= set(c_entries)
    assert set(_build.SOURCES) == {
        f[:-3] for f in os.listdir(_build.CSRC) if f.endswith(".cu")
    }
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_convert_splits_stacks_and_transposes():
    from ps_slm_tpu_torch import convert

    rng = np.random.default_rng(0)
    lin = lambda i, o, n: {  # noqa: E731
        "kernel": rng.normal(size=(n, i, o)), "bias": rng.normal(size=(n, o))
    }
    layers = {
        "input_layernorm": rng.normal(size=(2, 8)),
        "post_attention_layernorm": rng.normal(size=(2, 8)),
        **{k: lin(8, 8, 2) for k in ("q_proj", "k_proj", "v_proj")},
        **{k: {"kernel": rng.normal(size=(2, 8, 8))}
           for k in ("o_proj", "gate_proj", "up_proj", "down_proj")},
    }
    tree = {"embed_tokens": rng.normal(size=(5, 8)), "layers": layers,
            "norm": np.ones(8)}
    sd = convert.qwen2_state_dict(tree)
    assert "lm_head.weight" not in sd
    np.testing.assert_allclose(
        sd["layers.1.q_proj.weight"].numpy(),
        layers["q_proj"]["kernel"][1].T.astype(np.float32),
    )
    # PEFT leaves split per layer under their own names, LoRA in the JAX layout
    layers["q_proj"].update(lora_a=rng.normal(size=(2, 8, 3)), lora_b=rng.normal(size=(2, 3, 8)),
                            lora_scale=np.full((2,), 0.25))
    layers["adaption_gate"] = rng.normal(size=(2,))
    sd = convert.qwen2_state_dict(tree)
    np.testing.assert_allclose(sd["layers.1.q_proj.lora_a"].numpy(),
                               layers["q_proj"]["lora_a"][1].astype(np.float32))
    assert sd["layers.0.q_proj.lora_scale"].shape == sd["layers.1.adaption_gate"].shape == ()
    layers["unknown"] = np.zeros((2, 1))
    with pytest.raises(ValueError, match="unknown"):
        convert.qwen2_state_dict(tree)
