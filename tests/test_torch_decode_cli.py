"""PyTorch port: the decode CLI end to end against the JAX package's.

``ps_slm_tpu_torch.cli.decode.main(..., device="cpu")`` and
``ps_slm_tpu.cli.decode.main`` decode the same manifest (Kaldi ark, wav
and flac audio) in fp32 with ``max_new_tokens=8``, greedy and beam 2, and
must write byte-identical ``_pred`` and ``_gt`` files:

* random init: the JAX CLI's random weights (its factory, seeded from the
  config) reach the port as a full reference checkpoint that the JAX
  exporter writes (``ckpt_path``);
* the asset layout of ``scripts/decode.sh``: an HF Qwen2 directory with a
  byte-level tokenizer, a funasr SenseVoiceSmall directory with ``am.mvn``
  and a BPE model, and a projector checkpoint, written by ``chip_smoke.py``'s
  writers from a tiny port model; both CLIs load every file themselves.

Each JAX CLI run compiles its decode, ~10-20 s.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from ps_slm_tpu.cli import decode as jdecode
from ps_slm_tpu.config import RunConfig as JaxRunConfig
from ps_slm_tpu.config import parse_cli as jax_parse_cli
from ps_slm_tpu.data import audio_io as jaudio
from ps_slm_tpu.data import spm as jspm
from ps_slm_tpu.models.tasu import model_factory as jax_model_factory
from ps_slm_tpu.tools import wer as jwer
from ps_slm_tpu.training.checkpoint import export_reference_checkpoint as jax_export
from ps_slm_tpu_torch.cli import decode
from ps_slm_tpu_torch.config import ModelConfig, TrainConfig
from ps_slm_tpu_torch.data.flac import write_flac
from ps_slm_tpu_torch.models.tasu import model_factory
from ps_slm_tpu_torch.tools import clean_marks, wer

MAX_NEW = 8
TINY = [
    "++train_config.mixed_precision=false",
    f"++train_config.max_new_tokens={MAX_NEW}",
    "++dataset_config.eval_max_frame_length=300",
    "++dataset_config.feature_bucket=16",
    "++dataset_config.token_bucket=8",
]


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """tests/test_cli.py's fixture (8 utterances of 0.5-1 s in a wav.ark)
    plus one .wav and one .flac utterance."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    rate = 16000
    entries = {f"utt{i}": (rate, rng.normal(size=int(rng.integers(rate // 2, rate))).astype(
        np.float32) * 0.1) for i in range(8)}
    offsets = jaudio.write_kaldi_wav_ark(str(d / "wav.ark"), entries)
    rows = [{"key": k, "path": f"{d / 'wav.ark'}:{off}", "target": f"word{i} hello",
             "GT": f"word{i} hello", "task": "ASR"} for i, (k, off) in enumerate(offsets.items())]
    x = (rng.normal(size=12000) * 0.1).astype(np.float32)
    jaudio.write_wav(str(d / "a.wav"), rate, x)
    write_flac(str(d / "b.flac"), rate, x[::-1].copy())
    rows += [{"key": "wav0", "path": str(d / "a.wav"), "target": "the cat", "GT": "the cat",
              "task": "ASR"},
             {"key": "flac0", "path": str(d / "b.flac"), "target": "a mat", "GT": "a mat",
              "task": "ASR"}]
    (d / "test").mkdir()
    (d / "test" / "multitask.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    (d / "multiprompt.jsonl").write_text(json.dumps({"task": "ASR", "prompt": "transcribe:"}) + "\n")
    return d


def _random_args(d):
    return [
        "++model_config.llm_path=",
        "++model_config.encoder_projector=linear-silu",
        "++model_config.encoder_dim=11",
        "++model_config.llm_dim=64",
        '++model_config.encoder_config_overrides={"input_size": 560}',
        "++train_config.ctc_posterior=true",
        "++train_config.do_psd=true",
        f"++dataset_config.multitask_prompt_path={d}/multiprompt.jsonl",
        f"++dataset_config.test_scp_file_path={d}/test",
        f"++log_config.log_file={d}/log.txt",
    ] + TINY


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """scripts/decode.sh's layout at tiny widths: Qwen2.5's specials at
    256-258, a 560-wide am.mvn, a BPE model beside the encoder."""
    root = str(tmp_path_factory.mktemp("assets"))
    model = model_factory(
        TrainConfig(ctc_posterior=True, do_psd=True, seed=3),
        ModelConfig(llm_dim=64, encoder_dim=11, llm_config_overrides=dict(vocab_size=300),
                    encoder_config_overrides=dict(input_size=560)), device="cpu")
    out = chip_smoke.write_assets(
        root, model, llm_dtype=torch.bfloat16,
        specials={"<|endoftext|>": 256, "<|im_start|>": 257, "<|im_end|>": 258},
        utts={"ark": 4, "wav": 1, "flac": 1}, seconds=(0.5, 1.0))
    pieces = [("<blank>", 0.0, jspm.TYPE_CONTROL), ("<unk>", 0.0, jspm.TYPE_UNKNOWN),
              ("</s>", 0.0, jspm.TYPE_CONTROL)] + [(c, -1.0, jspm.TYPE_NORMAL) for c in "▁abcdefghi"]
    with open(os.path.join(out["encoder_path"], "chn_jpn_yue_eng_ko_spectok.bpe.model"), "wb") as f:
        f.write(jspm.serialize_model_proto(pieces))
    out["root"] = root
    return out


def _decode_both(jax_args, port_args, out_dir):
    assert jdecode.main(jax_args + [f"decode_log={out_dir}/jax/test"]) == 0
    assert decode.main(port_args + [f"decode_log={out_dir}/port/test"], device="cpu") == 0
    files = {}
    for side in ("jax", "port"):
        for suffix in ("_pred", "_gt"):
            with open(f"{out_dir}/{side}/test{suffix}", "rb") as f:
                files[side, suffix] = f.read()
    return files


@pytest.mark.parametrize("beams", [1, 2])
def test_random_init_decode_files_equal_jax(fixtures, tmp_path, beams):
    args = _random_args(fixtures) + [f"++train_config.num_beams={beams}"]
    cfg = jax_parse_cli(args, JaxRunConfig())
    jm = jax_model_factory(cfg.train_config, cfg.model_config,
                           rng=jax.random.PRNGKey(cfg.train_config.seed))
    jax_export(jm, str(tmp_path / "full.bin"))
    files = _decode_both(args, args + [f"ckpt_path={tmp_path / 'full.bin'}"], tmp_path)
    assert files["jax", "_pred"] == files["port", "_pred"]
    assert files["jax", "_gt"] == files["port", "_gt"]
    assert files["port", "_pred"].count(b"\n") == 10


@pytest.mark.parametrize("beams", [1, 2])
def test_asset_layout_decode_files_equal_jax(assets, tmp_path, beams):
    args = chip_smoke.decode_args(assets, "unused", MAX_NEW, llm_dim=64, encoder_dim=11)
    args = [a for a in args if not a.startswith(("decode_log=", "++log_config"))]
    args += TINY + [f"++train_config.num_beams={beams}",
                    f"++log_config.log_file={tmp_path}/log.txt"]
    files = _decode_both(args, args, tmp_path)
    assert files["jax", "_pred"] == files["port", "_pred"]
    assert files["jax", "_gt"] == files["port", "_gt"]
    keys = [line.split(b"\t")[0] for line in files["port", "_gt"].splitlines()]
    assert sorted(keys) == sorted([b"ark00", b"ark01", b"ark02", b"ark03", b"wav00", b"flac00"])
    # the port's scorer on the port's files gives the JAX scorer's numbers
    pred, gt = f"{tmp_path}/port/test_pred", f"{tmp_path}/port/test_gt"
    for path in (pred, gt):
        clean_marks.clean_file(path)
    with open(os.devnull, "w") as null:
        assert wer.score_files(gt, pred, stream=null) == jwer.score_files(gt, pred, stream=null)


def test_host_shards_merge_to_the_single_host_decode(fixtures, tmp_path, monkeypatch):
    args = _random_args(fixtures) + ["++train_config.num_beams=1"]
    assert decode.main(args + [f"decode_log={tmp_path}/one/test"], device="cpu") == 0
    parts = {}
    for host in (0, 1):
        monkeypatch.setenv("PS_NUM_HOSTS", "2")
        monkeypatch.setenv("PS_HOST_ID", str(host))
        assert decode.main(args + [f"decode_log={tmp_path}/two/test"], device="cpu") == 0
        with open(f"{tmp_path}/two/test.part{host}_pred") as f:
            parts[host] = dict(line.rstrip("\n").split("\t", 1) for line in f)
    with open(f"{tmp_path}/one/test_pred") as f:
        want = dict(line.rstrip("\n").split("\t", 1) for line in f)
    assert not parts[0].keys() & parts[1].keys()
    assert {**parts[0], **parts[1]} == want


def test_token_ids_outside_the_llm_vocabulary_raise(fixtures):
    """A tokenizer whose special ids do not fit the LLM's embedding rows
    (the stub's <speech> is 254) fails before any batch is decoded."""
    args = _random_args(fixtures) + ['++model_config.llm_config_overrides={"vocab_size": 200}']
    with pytest.raises(ValueError, match="outside the LLM's 200 embedding rows"):
        decode.main(args, device="cpu")
