"""PyTorch port: the three tools of the last slice against the JAX package.

* ``tools/posterior_analysis.py``: every function on seeded posteriors
  and the CLI on both HDF5 layouts give the JAX module's values exactly
  (the same numpy arithmetic); the HDF5 and plotting parts skip without
  ``h5py`` / ``matplotlib``, as tests/test_posterior_analysis.py does.
* ``tools/goldens.py``: ``verify`` (CPU, fp32) passes on goldens written
  by the JAX package's own ``sensevoice.encode`` / ``ctc_logits`` and Qwen2
  forward, through the JAX loaders, from a synthetic funasr and HF
  directory (the port's writers), at the JAX tool's ``ATOL`` (2e-4, 10x
  for logits); it fails once one encoder weight is corrupted; ``capture``
  raises ``NotImplementedError``.
* ``tools/asset_day.py``'s dry run (CPU) writes the asset layout at tiny
  widths and produces both recipe rows with ``"goldens": null`` and its
  reason; the JAX ``decode_and_score`` on the same assets writes a
  byte-identical ``_pred``.

CPU time alone: ~40 s (the JAX decode compiles once).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_slm_tpu.tools import posterior_analysis as jpa
from ps_slm_tpu_torch.tools import asset_day, goldens
from ps_slm_tpu_torch.tools import posterior_analysis as pa

FUNCS = ("interp_to_length", "js_distance_frame_mean", "symmetric_ce", "top1_agreement",
         "collapse_ctc", "edit_distance", "blank_fraction", "mean_entropy", "analyze_pair",
         "interp_logits_then_softmax", "pair_metrics")


def _dist(rng, t, v):
    return rng.dirichlet(np.ones(v) * 0.3, size=t).astype(np.float64)


def test_posterior_analysis_functions_equal_jax():
    assert all(hasattr(pa, f) for f in FUNCS + ("analyze_h5", "analyze_triplet_h5", "main"))
    rng = np.random.default_rng(0)
    for _ in range(4):
        t1, t2, v = (int(x) for x in rng.integers(3, 17, size=3))
        p, q = _dist(rng, t1, v), _dist(rng, t2, v)
        logits = rng.normal(size=(t1, v))
        q1 = pa.interp_to_length(q, t1)
        np.testing.assert_array_equal(q1, jpa.interp_to_length(q, t1))
        for f in ("js_distance_frame_mean", "symmetric_ce", "top1_agreement"):
            assert getattr(pa, f)(p, q1) == getattr(jpa, f)(p, q1), f
        for f in ("collapse_ctc", "blank_fraction", "mean_entropy"):
            assert getattr(pa, f)(p) == getattr(jpa, f)(p), f
        a, b = pa.collapse_ctc(p), pa.collapse_ctc(q)
        assert pa.edit_distance(a, b) == jpa.edit_distance(a, b)
        assert pa.analyze_pair(p, q, blank=1) == jpa.analyze_pair(p, q, blank=1)
        np.testing.assert_array_equal(pa.interp_logits_then_softmax(logits, t2),
                                      jpa.interp_logits_then_softmax(logits, t2))
        assert pa.pair_metrics(p, q1, "ctc", "clean") == jpa.pair_metrics(p, q1, "ctc", "clean")


def test_posterior_analysis_h5_and_cli_equal_jax(tmp_path, capsys):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(3)
    pair = tmp_path / "pair.h5"
    with h5py.File(pair, "w") as f:
        for k in range(3):
            g = f.create_group(f"utt{k}")
            g["real"] = _dist(rng, 10, 6)
            g["sim"] = _dist(rng, 8, 6)
    assert pa.analyze_h5(str(pair)) == jpa.analyze_h5(str(pair))
    assert pa.main([str(pair), str(tmp_path / "p.json")]) == 0
    assert json.loads((tmp_path / "p.json").read_text()) == jpa.analyze_h5(str(pair))
    pytest.importorskip("matplotlib")
    trip = tmp_path / "triplet.h5"
    with h5py.File(trip, "w") as f:
        for g in ("ctc", "clean", "noise"):
            grp = f.create_group(g)
            for k in range(3):
                grp[f"utt{k}"] = rng.normal(size=(int(rng.integers(6, 14)), 6)).astype(np.float32)
    got = pa.analyze_triplet_h5(str(trip), str(tmp_path / "port"), jobs=1)
    want = jpa.analyze_triplet_h5(str(trip), str(tmp_path / "jax"), jobs=1)
    assert (got["n_utts"], got["delta_mean"], got["delta_neg_frac"]) == (
        want["n_utts"], want["delta_mean"], want["delta_neg_frac"])
    assert open(got["csv"]).read() == open(want["csv"]).read()
    assert all(os.path.getsize(p) > 0 for p in got["plots"])
    assert pa.main([str(trip), str(tmp_path / "cli"), "--jobs", "1"]) == 0
    assert "delta mean" in capsys.readouterr().out


# ----------------------------------------------------------------------------
# goldens.verify
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden_dirs(tmp_path_factory):
    """A funasr encoder dir and an HF LLM dir written from tiny port
    modules, and goldens from the JAX package's modules on them."""
    from ps_slm_tpu.models import qwen2 as jqwen2
    from ps_slm_tpu.models import sensevoice as jsv
    from ps_slm_tpu.training.checkpoint import load_funasr_encoder as jax_load_encoder
    from ps_slm_tpu_torch.models.qwen2 import Qwen2Config, Qwen2Model
    from ps_slm_tpu_torch.models.sensevoice import SenseVoiceConfig, SenseVoiceEncoder
    from ps_slm_tpu_torch.tools._assets import write_encoder_dir, write_llm_dir

    d = tmp_path_factory.mktemp("goldens")
    g = torch.Generator().manual_seed(0)
    enc = SenseVoiceEncoder(SenseVoiceConfig.tiny(input_size=560, output_size=32,
                                                  attention_heads=2, linear_units=48,
                                                  num_blocks=3, tp_blocks=1, vocab_size=25))
    enc.init_weights(g)
    llm = Qwen2Model(Qwen2Config.tiny(vocab_size=300))
    llm.init_weights(g)
    enc_dir, llm_dir = str(d / "SenseVoiceSmall"), str(d / "Qwen")
    write_encoder_dir(enc_dir, enc)
    write_llm_dir(llm_dir, llm, torch.float32,
                  specials={"<|endoftext|>": 256, "<|im_start|>": 257, "<|im_end|>": 258})

    feats, lens = goldens._fixture()
    params, cfg = jax_load_encoder(enc_dir)
    with jax.default_matmul_precision("highest"):
        hid, _ = jsv.encode(params, cfg, jnp.asarray(feats), jnp.asarray(lens), use_flash=False)
        logits = jsv.ctc_logits(params, hid)
        lparams, lcfg = jqwen2.load_hf_checkpoint(llm_dir, dtype=jnp.float32)
        ids = np.random.default_rng(1).integers(0, 300, size=(2, 16))
        lh, _ = jqwen2.forward(lparams, lcfg, jqwen2.embed(lparams, jnp.asarray(ids)),
                               attention_mask=jnp.ones(ids.shape, bool), use_flash=False)
        llm_logits = jqwen2.unembed(lparams, lh)
    npz = str(d / "goldens.npz")
    np.savez(npz, enc_hidden=np.asarray(hid), ctc_logits=np.asarray(logits), llm_ids=ids,
             llm_logits=np.asarray(llm_logits))
    return npz, enc_dir, llm_dir


def test_goldens_verify_passes_on_jax_goldens(golden_dirs):
    npz, enc_dir, llm_dir = golden_dirs
    lines = []
    assert goldens.verify(npz, encoder_dir=enc_dir, llm_dir=llm_dir, device="cpu",
                          log=lines.append) == 0
    assert lines[-1] == "PASS" and len(lines) == 4
    assert goldens.main(["verify", npz, "--encoder-dir", enc_dir], device="cpu") == 0
    with pytest.raises(NotImplementedError, match="reference source tree"):
        goldens.main(["capture", npz, "--encoder-dir", enc_dir], device="cpu")


def test_goldens_verify_fails_on_a_corrupted_weight(golden_dirs, tmp_path):
    import shutil

    npz, enc_dir, _ = golden_dirs
    bad = str(tmp_path / "bad")
    shutil.copytree(enc_dir, bad)
    state = torch.load(os.path.join(bad, "model.pt"), weights_only=True)
    key = next(k for k in state if k.endswith("feed_forward.w_1.weight"))
    state[key] = state[key] + 0.05 * torch.randn(state[key].shape,
                                                 generator=torch.Generator().manual_seed(0))
    torch.save(state, os.path.join(bad, "model.pt"))
    lines = []
    assert goldens.verify(npz, encoder_dir=bad, device="cpu", log=lines.append) == 1
    assert lines[-1] == "FAIL"


# ----------------------------------------------------------------------------
# asset_day --dry-run
# ----------------------------------------------------------------------------

def test_asset_day_dry_run_rows_and_jax_decode(tmp_path):
    from ps_slm_tpu.tools import asset_day as jasset_day

    workdir = str(tmp_path / "day")
    assert asset_day.main(["--dry-run", "--workdir", workdir], device="cpu") == 0
    with open(os.path.join(workdir, "BASELINE_QUALITY.json")) as f:
        out = json.load(f)
    assert out["goldens"] is None and "goldens.npz" in out["goldens_reason"]
    assert {r["recipe"] for r in out["rows"]} == set(asset_day.RECIPES)
    for row in out["rows"]:
        assert row["n_ref_tokens"] > 0
        prefix = os.path.join(workdir, f"{row['recipe']}_{row['test_set']}", "test")
        for suffix in ("_pred", "_gt", "_wer"):
            assert os.path.exists(prefix + suffix), prefix + suffix
    assets = os.path.join(workdir, "dry_assets")
    extra = ["++train_config.max_new_tokens=12", "++dataset_config.eval_max_frame_length=96",
             "++dataset_config.prompt_style={} <speech> "]
    jprefix = str(tmp_path / "jax" / "test")
    jasset_day.decode_and_score(
        os.path.join(assets, "SenseVoiceSmall"), os.path.join(assets, "Qwen2.5-1.5B-Instruct"),
        os.path.join(assets, "half_audio_finetuned", "pytorch_model.bin"),
        os.path.join(assets, "test_sets", "synthetic"), os.path.join(assets, "multiprompt.jsonl"),
        jprefix, extra_args=extra, log=lambda *_: None)
    port = os.path.join(workdir, "half_audio_finetuned_synthetic", "test")
    for suffix in ("_pred", "_gt"):
        with open(port + suffix, "rb") as a, open(jprefix + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
