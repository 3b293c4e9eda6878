"""PyTorch port: the whisper front end (``ops/fbank.py::whisper_log_mel``,
``pad_or_trim``, the collator's ``encoder == "whisper"`` branch) against
the JAX package.

The port computes the STFT in float64 on the host path (the collator's),
JAX in fp32; the log10 of a mel bin far below its frame's peak carries
the fp32 FFT's error (ROADMAP.md, 'Front end'), and the (x + 4) / 4
scaling and the max - 8 clamp bound what is left.  Tolerance after the
scaling: 5e-5 absolute for any bin (measured: 9e-6 from float64, 1.5e-5
from fp32), 1e-6 for the median bin; the filters, the pad / trim and the
shapes are exact.  CPU time alone: ~10 s.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_slm_tpu.config import DataConfig as JaxDataConfig
from ps_slm_tpu.data import audio_io
from ps_slm_tpu.data.dataset import get_speech_dataset as jax_dataset
from ps_slm_tpu.data.tokenizer import StubTokenizer as JaxStub
from ps_slm_tpu.ops import fbank as jfb
from ps_slm_tpu_torch.config import DataConfig
from ps_slm_tpu_torch.data.dataset import get_speech_dataset
from ps_slm_tpu_torch.data.tokenizer import StubTokenizer
from ps_slm_tpu_torch.ops import fbank as fb

ATOL = 5e-5
MEDIAN_ATOL = 1e-6


def _signal(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.4 * np.sin(2 * np.pi * 331 * t) + 0.1 * rng.normal(size=n)).astype(np.float32)


def _close(got, want):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert err.max() <= ATOL, err.max()
    assert np.median(err) <= MEDIAN_ATOL, np.median(err)


def test_mel_filters_equal_jax():
    for n_mels in (80, 128):
        np.testing.assert_array_equal(fb._mel_slaney(n_mels, 400, 16000),
                                      jfb._mel_slaney(n_mels, 400, 16000))


@pytest.mark.parametrize("n", [16000 * 2, 480000, 500000])
def test_pad_or_trim_equals_jax(n):
    x = _signal(n)
    want = np.asarray(jfb.pad_or_trim(jnp.asarray(x)))
    got = fb.pad_or_trim(torch.from_numpy(x)).numpy()
    assert got.shape == (480000,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_whisper_log_mel_equals_jax(dtype):
    wav = np.stack([np.asarray(jfb.pad_or_trim(jnp.asarray(_signal(n, seed=s))))
                    for s, n in ((1, 16000 * 3), (2, 16000 * 30), (3, 4000))])
    want = np.asarray(jfb.whisper_log_mel(jnp.asarray(wav), n_mels=128))
    got = fb.whisper_log_mel(torch.from_numpy(wav).to(dtype), n_mels=128)
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, 128, 3000)
    _close(got.numpy(), want)


def _manifest(tmp_path, config, rows):
    split = tmp_path / "train"
    split.mkdir(exist_ok=True)
    with open(split / "multitask.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    prompt = tmp_path / "multiprompt.jsonl"
    prompt.write_text(json.dumps({"task": "ASR", "prompt": "transcribe:"}) + "\n")
    return config(multitask_prompt_path=str(prompt), train_scp_file_path=str(split),
                  train_max_frame_length=20000, ds_rate=1, feature_bucket=16,
                  token_bucket=8, encoder="whisper")


def test_collator_whisper_batch_equals_jax(tmp_path):
    """tests/test_flac_whisper.py's whisper batch, through both collators."""
    rows = []
    for i, secs in enumerate((2.0, 0.7)):
        path = tmp_path / f"v{i}.wav"
        audio_io.write_wav(str(path), 16000, _signal(int(16000 * secs), seed=5 + i))
        rows.append({"key": f"v{i}", "path": str(path), "target": "hello", "GT": "hello",
                     "task": "ASR"})
    want = list(jax_dataset(_manifest(tmp_path, JaxDataConfig, rows), JaxStub(), "train",
                            fixed_batch_size=2))
    got = list(get_speech_dataset(_manifest(tmp_path, DataConfig, rows), StubTokenizer(),
                                  "train", fixed_batch_size=2))
    assert len(got) == len(want) == 1
    g, w = got[0], want[0]
    assert "waveform" not in g and g["input_features"].shape == (2, 3000, 128)
    assert sorted(g) == sorted(w)
    _close(g["input_features"], w["input_features"])
    for k in ("input_feature_length", "audio_seconds", "input_ids", "attention_mask", "labels"):
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
