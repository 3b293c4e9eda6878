"""PyTorch port: the TASU branches beyond the published recipes, against
the JAX package (CPU).

voca_trans (LegoSLM, PSD on and off, ``top1_emb`` on and off, the forward's
and generate's PSD blank ids), the cross-attention projector over the
posterior, the raw-feature baseline (``ctc_posterior=False``) and the
q-former: one tiny model each, built by the JAX factory and carried into
the port by ``convert.from_jax_params``; the same seeded numpy batch goes
through ``prepare_merged`` (training and generate mode) and the training
forward of both.  Then the decode CLI with the q-former against the JAX
CLI, and the port's decode CLI on every branch.

The q-former's span in the merge is ``query_len`` long in the port, the
frame count in JAX (ROADMAP.md queue 3, faults of the reference): the two
agree where every row has ``query_len`` unpadded frames, which is where
they are compared.

Tolerances (fp32): embeddings and losses 1e-5 (absolute and relative);
masks, labels, positions and lengths equal; decode files byte-identical.
About 51 s alone on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_slm_tpu.cli import decode as jdecode
from ps_slm_tpu.config import ModelConfig as JaxModelConfig
from ps_slm_tpu.config import RunConfig as JaxRunConfig
from ps_slm_tpu.config import TrainConfig as JaxTrainConfig
from ps_slm_tpu.config import parse_cli as jax_parse_cli
from ps_slm_tpu.data import audio_io as jaudio
from ps_slm_tpu.models import tasu as jtasu
from ps_slm_tpu.training.checkpoint import export_reference_checkpoint as jax_export
from ps_slm_tpu_torch import convert
from ps_slm_tpu_torch.cli import decode
from ps_slm_tpu_torch.config import ModelConfig, TrainConfig
from ps_slm_tpu_torch.models import tasu

SPEECH = 250
ENC_VOCAB, ENC_DIM, LLM_VOCAB, LLM_DIM = 11, 16, 256, 64   # the tiny configs' widths
TOL = dict(atol=1e-5, rtol=1e-5)
VOCA = dict(ctc_posterior=True, voca_trans=True, voca_trans_blank_id=LLM_VOCAB - 1)
QF = dict(qformer_layers=2, qformer_heads=4, query_len=6)
BRANCHES = {   # name -> (projector, model config, train flags)
    "voca_trans": ("simple_linear", dict(encoder_dim=ENC_DIM, llm_dim=LLM_VOCAB,
                                         encoder_projector_ds_rate=2), dict(VOCA)),
    "voca_trans_psd": ("simple_linear", dict(encoder_dim=ENC_DIM, llm_dim=LLM_VOCAB,
                                             encoder_projector_ds_rate=2),
                       dict(VOCA, do_psd=True)),
    "voca_trans_psd_top1": ("simple_linear", dict(encoder_dim=ENC_DIM, llm_dim=LLM_VOCAB,
                                                  encoder_projector_ds_rate=2),
                            dict(VOCA, do_psd=True, top1_emb=True)),
    "cross_attention": ("cross-attention", dict(encoder_dim=ENC_VOCAB, ca_heads=4),
                        dict(ctc_posterior=True, do_psd=True)),
    "raw_features": ("linear", dict(encoder_dim=ENC_DIM, encoder_projector_ds_rate=2),
                     dict(ctc_posterior=False)),
    "raw_features_psd": ("linear", dict(encoder_dim=ENC_DIM, encoder_projector_ds_rate=2),
                         dict(ctc_posterior=False, do_psd=True)),
    "q_former": ("q-former", dict(encoder_dim=ENC_VOCAB, **QF), dict(ctc_posterior=True)),
}


def _pair(name):
    projector, mc, flags = BRANCHES[name]
    mc = dict(llm_dim=LLM_DIM, **mc) if "llm_dim" not in mc else mc
    jm = jtasu.model_factory(JaxTrainConfig(**flags),
                             JaxModelConfig(llm_path="", encoder_projector=projector, **mc),
                             rng=jax.random.PRNGKey(0))
    if flags.get("voca_trans"):
        # the CTC head's blank classes favoured: PSD merges and drops frames,
        # and the forward's blank (255) and generate's (0) pick other frames
        m = jm.params["projector"]["map"]
        m["bias"] = m["bias"].at[0].add(2.5).at[LLM_VOCAB - 1].add(2.5)
    jm.speech_token_id = SPEECH
    jm.use_flash = False
    pm = tasu.model_factory(TrainConfig(**flags), ModelConfig(encoder_projector=projector, **mc),
                            device="cpu")
    pm.load_state_dict(convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params)))
    pm.speech_token_id = SPEECH
    return jm, pm


def _batch(frames, seed=0):
    rng = np.random.default_rng(seed)
    b, s = len(frames), 10
    ids = rng.integers(1, 200, size=(b, s)).astype(np.int32)
    ids[:, 3] = SPEECH
    mask = np.ones((b, s), bool)
    mask[1, -2:] = False
    ids[1, -2:] = 0
    labels = np.where(mask, ids, -100).astype(np.int32)
    labels[:, :5] = -100
    np_batch = {
        "input_ids": ids, "attention_mask": mask, "labels": labels,
        "input_features": rng.normal(size=(b, max(frames), 24)).astype(np.float32),
        "input_feature_length": np.array(frames, np.int32),
    }
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    for k in ("input_ids", "labels", "input_feature_length"):
        tb[k] = tb[k].long()
    return jb, tb


def _frames(name):
    # the q-former is compared where the reference is right: every row
    # query_len frames, none padded
    return [QF["query_len"]] * 2 if name == "q_former" else [12, 9]


@pytest.mark.parametrize("name", list(BRANCHES))
def test_prepare_merged_and_loss_match_jax(name):
    jm, pm = _pair(name)
    jb, tb = _batch(_frames(name))
    merged = {}
    for gen in (False, True):
        want = jax.jit(lambda p, b: jtasu.prepare_merged(
            jm, p, b, left_padding=gen, generate_mode=gen, train=False))(jm.params, jb)
        got = tasu.prepare_merged(pm, tb, left_padding=gen, generate_mode=gen)
        np.testing.assert_allclose(got.embeds.detach().numpy(), np.asarray(want.embeds), **TOL)
        np.testing.assert_array_equal(got.attention_mask.numpy(), np.asarray(want.attention_mask))
        np.testing.assert_array_equal(got.position_ids.numpy(), np.asarray(want.position_ids))
        if not gen:
            np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
        merged[gen] = got
    if name.startswith("voca_trans_psd"):
        # the forward's PSD blank (255) and generate's (0) differ
        assert not torch.equal(merged[False].attention_mask.sum(1),
                               merged[True].attention_mask.sum(1)) or not torch.allclose(
            merged[False].embeds.sum(1), merged[True].embeds.sum(1))
    want_loss, want_m = jax.jit(lambda p: jtasu.forward(jm, p, jb, jax.random.PRNGKey(1)))(
        jm.params)
    loss, metrics = tasu.forward(pm, tb)
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    np.testing.assert_allclose(metrics["acc"].item(), float(want_m["acc"]), **TOL)
    assert int(metrics["ntokens"]) == int(want_m["ntokens"]) > 0
    loss.backward()
    grads = [p.grad for p in pm.projector.parameters()]
    if BRANCHES[name][2].get("top1_emb"):
        assert all(g is None for g in grads)      # the argmax passes no gradient
    else:
        assert all(torch.isfinite(g).all() for g in grads)


def test_qformer_span_is_query_len_on_ragged_rows():
    """Ragged and padded rows: each row's span is query_len embeddings, and a
    row's padded frames change nothing."""
    _, pm = _pair("q_former")
    _, tb = _batch([9, 4])
    got = tasu.compute_audio_embeds(pm, tb)
    assert got[0].shape[1] == QF["query_len"] and got[1].tolist() == [QF["query_len"]] * 2
    tb["input_features"][1, 4:] = 50.0
    again = tasu.compute_audio_embeds(pm, tb)
    torch.testing.assert_close(again[0], got[0])


# ----------------------------------------------------------------------------
# the decode CLI
# ----------------------------------------------------------------------------

QF_SAMPLES = 400 + 160 * 35     # 36 fbank frames -> 6 LFR frames, the query_len


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """4 utterances of exactly ``query_len`` LFR frames (the q-former's
    comparison), in a wav.ark."""
    d = tmp_path_factory.mktemp("branches")
    rng = np.random.default_rng(0)
    entries = {f"utt{i}": (16000, (rng.normal(size=QF_SAMPLES) * 0.1).astype(np.float32))
               for i in range(4)}
    offsets = jaudio.write_kaldi_wav_ark(str(d / "wav.ark"), entries)
    rows = [{"key": k, "path": f"{d / 'wav.ark'}:{off}", "target": f"word{i}", "GT": f"word{i}",
             "task": "ASR"} for i, (k, off) in enumerate(offsets.items())]
    (d / "test").mkdir()
    (d / "test" / "multitask.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    (d / "multiprompt.jsonl").write_text(json.dumps({"task": "ASR", "prompt": "go:"}) + "\n")
    return d


def _args(d, projector, encoder_dim, *extra):
    return [
        "++model_config.llm_path=",
        f"++model_config.encoder_projector={projector}",
        f"++model_config.encoder_dim={encoder_dim}",
        f"++model_config.llm_dim={LLM_DIM}",
        '++model_config.encoder_config_overrides={"input_size": 560}',
        "++train_config.mixed_precision=false",
        "++train_config.max_new_tokens=6",
        "++train_config.num_beams=1",
        f"++dataset_config.multitask_prompt_path={d}/multiprompt.jsonl",
        f"++dataset_config.test_scp_file_path={d}/test",
        f"++log_config.log_file={d}/log.txt",
        *extra,
    ]


def test_qformer_decode_cli_files_equal_jax(fixtures, tmp_path):
    """The JAX CLI's random q-former model reaches the port through the JAX
    exporter's reference checkpoint (the q-former's HF names)."""
    args = _args(fixtures, "q-former", ENC_VOCAB, "++train_config.ctc_posterior=true",
                 *(f"++model_config.{k}={v}" for k, v in QF.items()))
    cfg = jax_parse_cli(args, JaxRunConfig())
    jm = jtasu.model_factory(cfg.train_config, cfg.model_config,
                             rng=jax.random.PRNGKey(cfg.train_config.seed))
    jax_export(jm, str(tmp_path / "full.bin"))
    assert jdecode.main(args + [f"decode_log={tmp_path}/jax/test"]) == 0
    assert decode.main(args + [f"ckpt_path={tmp_path / 'full.bin'}",
                               f"decode_log={tmp_path}/port/test"], device="cpu") == 0
    for suffix in ("_pred", "_gt"):
        with open(f"{tmp_path}/jax/test{suffix}", "rb") as a, \
                open(f"{tmp_path}/port/test{suffix}", "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("branch", ["voca_trans", "cross-attention", "raw_features",
                                    "ctc_linear"])
def test_decode_cli_runs_every_branch(fixtures, tmp_path, branch):
    if branch == "voca_trans":
        args = _args(fixtures, "simple_linear", ENC_DIM, "++train_config.ctc_posterior=true",
                     "++train_config.voca_trans=true", "++train_config.do_psd=true",
                     "++train_config.top1_emb=true")
        args = [a for a in args if "llm_dim" not in a] + [f"++model_config.llm_dim={LLM_VOCAB}"]
    elif branch == "cross-attention":
        args = _args(fixtures, "cross-attention", ENC_VOCAB, "++train_config.ctc_posterior=true",
                     "++model_config.ca_heads=4")
    elif branch == "raw_features":
        args = _args(fixtures, "cov1d-linear", ENC_DIM, "++train_config.ctc_posterior=false",
                     "++model_config.encoder_projector_ds_rate=2")
    else:
        path = str(tmp_path / "ctc.pt")
        g = torch.Generator().manual_seed(0)
        torch.save({"ctc_head.weight": torch.randn(LLM_DIM, 2 * ENC_VOCAB, generator=g),
                    "ctc_head.bias": torch.randn(LLM_DIM, generator=g)}, path)
        args = _args(fixtures, "simple_linear", ENC_VOCAB, "++train_config.ctc_posterior=true",
                     "++model_config.encoder_projector_ds_rate=2",
                     f"++model_config.ctc_linear={path}")
    assert decode.main(args + [f"decode_log={tmp_path}/test"], device="cpu") == 0
    with open(f"{tmp_path}/test_pred") as f:
        assert len(f.read().splitlines()) == 4
    assert os.path.getsize(f"{tmp_path}/test_gt") > 0


def test_train_step_gives_unreached_parameters_zero_gradients():
    """voca_trans with ``top1_emb`` passes no gradient to the projector (an
    argmax) and, with the encoder and the LLM frozen, none at all: the step
    still runs, and AdamW decays the projector as optax does on jax.grad's
    zero gradient (the lr of step 2 times the weight decay)."""
    from ps_slm_tpu_torch.training.step import make_train_step
    from ps_slm_tpu_torch.training.train_state import warmup_cosine

    projector, mc, flags = BRANCHES["voca_trans_psd_top1"]
    flags = dict(flags, freeze_llm=True, freeze_encoder=True, lr=1e-2, warmup_steps=1,
                 weight_decay=0.1)
    tc = TrainConfig(**flags)
    model = tasu.model_factory(tc, ModelConfig(encoder_projector=projector, **mc), device="cpu")
    model.speech_token_id = SPEECH
    _, tb = _batch([12, 9])
    step = make_train_step(model, tc, device="cpu")
    start = model.projector.map.weight.detach().clone()
    for _ in range(2):
        metrics = step(tb)
    assert torch.isfinite(metrics["loss"])
    lr = warmup_cosine(tc.lr, tc.warmup_steps, tc.total_steps)(1)
    torch.testing.assert_close(model.projector.map.weight, start * (1 - lr * tc.weight_decay))


def test_compute_accuracy_and_device_peak_match_jax():
    from ps_slm_tpu.utils import flops as jflops
    from ps_slm_tpu.utils import metric as jmetric
    from ps_slm_tpu_torch.utils import flops, metric

    rng = np.random.default_rng(3)
    pred = rng.integers(0, 4, size=(3, 9))
    tgt = rng.integers(0, 4, size=(3, 9))
    tgt[rng.uniform(size=tgt.shape) < 0.4] = -100
    want = float(jmetric.compute_accuracy(jnp.asarray(pred), jnp.asarray(tgt)))
    got = metric.compute_accuracy(torch.tensor(pred), torch.tensor(tgt)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert metric.compute_accuracy(torch.tensor(pred), torch.full((3, 9), -100)).item() == 0.0
    # the CPU has no peak in either package (the JAX one knows TPUs only)
    assert flops.device_peak_tflops("cpu") is None and jflops.device_peak_tflops() is None
