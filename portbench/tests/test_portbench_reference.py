"""The reference against the port's CPU path at small widths: the same
inputs and weights through both give the same answers, piece by piece
and for whole runs of the cells.  (The tests import the port; the
reference does not.)"""

import json
import os

import numpy as np
import pytest
import torch

from portbench import assets, feed, harness, traffic, weights
from portbench.reference import encoder as ref_enc
from portbench.reference import frontend as ref_fe
from portbench.reference import llm as ref_llm
from portbench.reference import tasu as ref_tasu
from portbench.tests.tiny import TINY, run_cell

CFG = json.load(open(os.path.join(harness.HERE, "configs", "tasu-sv-small-qwen2.5-1.5b.json")))
for part in ("encoder", "llm"):
    CFG[part].update(TINY[part])
CFG["dtype"] = "float32"
MIX = {"utterances": 4, "seconds": [1.0, 3.0], "tokens_per_second": 3.5, "burst_duty": 0.3}


@pytest.fixture(scope="module")
def model():
    w = weights.make(CFG, 7, "cpu")
    m, *_ = harness.build_tasu(CFG, CFG["recipes"]["half_audio"], 7, w, weights.cmvn(CFG, 7, "cpu"),
                               "cpu")
    return m, weights.make(CFG, 7, "cpu")


def test_front_end_matches():
    from ps_slm_tpu_torch.ops.fbank import frontend

    u = traffic.utterances(MIX, 3, "cpu")[0]
    cmvn = weights.cmvn(CFG, 3, "cpu")
    feats, lens = frontend(torch.from_numpy(u.samples)[None], torch.tensor([len(u.samples)]),
                           cmvn=cmvn)
    ref = ref_fe.features(torch.from_numpy(u.samples), cmvn)
    assert int(lens[0]) == ref.shape[0] == ref_fe.n_lfr(len(u.samples))
    np.testing.assert_allclose(feats[0, :ref.shape[0]].numpy(), ref.numpy(), atol=2e-5)


def test_encoder_matches(model):
    m, w = model
    x = torch.randn(1, 9, 560, generator=torch.Generator().manual_seed(0))
    from ps_slm_tpu_torch.models.tasu import encode_speech

    hidden, post, _ = encode_speech(m.encoder, x, torch.tensor([9]))
    h, logits = ref_enc.encode(w["encoder"], CFG["encoder"], x[0], ref_tasu.QUERY_IDS)
    np.testing.assert_allclose(hidden[0].detach().numpy(), h[4:].numpy(), atol=1e-4)
    np.testing.assert_allclose(post[0].detach().numpy(),
                               torch.softmax(logits, -1)[4:].numpy(), atol=1e-6)


def test_llm_matches(model):
    m, w = model
    x = torch.randn(1, 11, CFG["llm"]["hidden_size"], generator=torch.Generator().manual_seed(1))
    hidden, _ = m.llm(x, torch.ones(1, 11, dtype=torch.bool), torch.arange(11)[None])
    ref = ref_llm.forward(w["llm"], CFG["llm"], x[0])
    np.testing.assert_allclose(hidden[0].detach().numpy(), ref.numpy(), atol=1e-4)


def test_psd_matches():
    from ps_slm_tpu_torch.ops.psd import psd

    g = torch.Generator().manual_seed(2)
    post = torch.softmax(torch.randn(1, 30, 6, generator=g) * 3, -1)
    post[0, ::3, 0] = 0.95
    post = post / post.sum(-1, keepdim=True)
    out, lens = psd(post, torch.tensor([30]), post, blank_id=0, blank_threshold=0.9)
    ref = ref_tasu.psd(post[0], threshold=0.9)
    assert int(lens[0]) == ref.shape[0]
    np.testing.assert_allclose(out[0, :ref.shape[0]].numpy(), ref.numpy(), atol=1e-6)


def test_int8_weights_match_the_ports_codes(model):
    from ps_slm_tpu_torch.models.quantization import dequantize_kernel, quantize_kernel

    _, w = model
    m = w["llm"]["layers.0.q_proj.weight"]
    port = dequantize_kernel(quantize_kernel(m.T)).T
    ref = ref_llm.int8_weights(w["llm"], CFG["llm"])["layers.0.q_proj.weight"]
    np.testing.assert_allclose(port.numpy(), ref.numpy(), rtol=0, atol=1e-6)


def test_tokenizers_match(tmp_path):
    from ps_slm_tpu_torch.data.spm import SenseVoiceTokenizer
    from ps_slm_tpu_torch.data.tokenizer import load_tokenizer

    tok = load_tokenizer(assets.write_llm_tokenizer(str(tmp_path / "llm")))
    text = feed.prompt_text(CFG["recipes"]["half_audio"]) + "the cat sat"
    assert tok.encode(text) == assets.token_ids(text)
    assert tok.speech_token_id == assets.SPECIAL_IDS[assets.SPEECH_TOKEN]
    assert tok.eos_token_id == assets.SPECIAL_IDS[assets.EOS]
    enc = SenseVoiceTokenizer(assets.write_bpe_model(str(tmp_path / "enc"), 64))
    assert enc.encode("the cat sat") == assets.bpe_ids("the cat sat")


@pytest.mark.parametrize("cell", ["tasu15.train_half_audio", "tasu15.train_text_only",
                                  "tasu15.decode_backlog"])
def test_cell_runs_correct_on_the_cpu(cell):
    out, run = run_cell(cell)
    assert out["correct"], out["checks"]
    assert run.readings.get("blank_share", 0.5) > 0.3 or "text_only" in cell
    for name, c in out["checks"].items():
        assert c["value"] <= max(1e-5, c["limit"] * 1e-3), (name, c)


def test_asr_one_utterance_a_batch_agrees_and_fp8_does_not():
    sizes = {k: dict(v) for k, v in TINY.items()}
    sizes["traffic"]["batch_seconds"] = 0.1             # one utterance a batch
    out, _ = run_cell("svsmall.asr_backlog", sizes=sizes)
    assert out["correct"], out["checks"]
    ctl, _ = run_cell("svsmall.asr_backlog", sizes=sizes, control="fp8")
    assert ctl["checks"]["greedy_gap"]["value"] > 100 * max(out["checks"]["greedy_gap"]["value"], 1e-6)
