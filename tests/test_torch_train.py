"""PyTorch port: the half_audio training path against the JAX package (CPU).

One tiny audio-TASU model with the published flags (CTC posterior + PSD +
linear-silu, encoder and LLM frozen), built by the JAX factory and
converted leaf by leaf into the port's TasuModel.  Inputs come from numpy
with a fixed seed.  On CPU tensors the port's kernel wrappers take their
plain versions, forward and backward.

Tolerances (fp32; the two sides sum in different orders): 1e-5 absolute
and relative for losses, accuracies and schedules; 1e-4 for gradients,
which pass back through the LLM's layers; 1e-4 absolute (1e-5 relative)
for projector weights after AdamW steps, whose update g / (|g| + eps)
multiplies a gradient's rounding by up to 1 / eps = 1e6 where |g| is
below eps (a few elements: gradients agree to ~1e-8 there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ps_slm_tpu.config import ModelConfig as JaxModelConfig
from ps_slm_tpu.config import TrainConfig as JaxTrainConfig
from ps_slm_tpu.models import qwen2 as jqwen2
from ps_slm_tpu.models import sensevoice as jsv
from ps_slm_tpu.models import tasu as jtasu
from ps_slm_tpu.ops import ce_loss as jce
from ps_slm_tpu.training import step as jstep
from ps_slm_tpu.training import train_state as jts
from ps_slm_tpu.utils import flops as jflops
from ps_slm_tpu_torch import convert
from ps_slm_tpu_torch.config import (
    BENCH_BATCH, BENCH_FRAMES, BENCH_TEXT_LEN, QWEN25_1_5B, SENSEVOICE_SMALL,
    ModelConfig, TrainConfig, half_audio_configs,
)
from ps_slm_tpu_torch.models import tasu
from ps_slm_tpu_torch.models.qwen2 import Qwen2Config
from ps_slm_tpu_torch.models.sensevoice import SenseVoiceConfig
from ps_slm_tpu_torch.ops import ce_loss
from ps_slm_tpu_torch.training.step import make_eval_step, make_train_step
from ps_slm_tpu_torch.training.train_state import warmup_cosine
from ps_slm_tpu_torch.utils import flops

SPEECH = 250
ENC_VOCAB, ENC_INPUT, LLM_DIM = 11, 24, 64   # the tiny configs' widths
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
WEIGHT_TOL = dict(atol=1e-4, rtol=1e-5)
HALF_AUDIO = dict(ctc_posterior=True, do_psd=True, freeze_llm=True, freeze_encoder=True)


def _pair(**train):
    flags = dict(HALF_AUDIO, **train)
    jtc = JaxTrainConfig(**flags)
    jm = jtasu.model_factory(
        jtc, JaxModelConfig(llm_path="", encoder_dim=ENC_VOCAB, llm_dim=LLM_DIM),
        rng=jax.random.PRNGKey(0),
    )
    jm.speech_token_id = SPEECH
    tc = TrainConfig(**flags)
    pm = tasu.model_factory(
        tc, ModelConfig(encoder_dim=ENC_VOCAB, llm_dim=LLM_DIM), device="cpu"
    )
    pm.load_state_dict(convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params)))
    pm.speech_token_id = SPEECH
    return jtc, jm, tc, pm


def _batch(b=3, s=6, a=16, seed=0):
    """Ragged frame counts, the speech token at 3, the first two labels
    ignored, and a right-padded last row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 200, size=(b, s)).astype(np.int32)
    ids[:, 3] = SPEECH
    mask = np.ones((b, s), bool)
    mask[-1, -1] = False
    labels = np.where(mask, ids, -100).astype(np.int32)
    labels[:, :2] = -100
    np_batch = {
        "input_ids": ids,
        "attention_mask": mask,
        "labels": labels,
        "input_features": rng.normal(size=(b, a, ENC_INPUT)).astype(np.float32),
        "input_feature_length": np.array([a, a - 5, 3][:b], np.int32),
    }
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    for k in ("input_ids", "labels", "input_feature_length"):
        tb[k] = tb[k].long()
    return jb, tb


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), **tol)


@pytest.mark.parametrize("form", ["gathered", "chunked"])
def test_ce_losses_match_jax(form):
    rng = np.random.default_rng(1)
    b, t, h, v = 3, 21, 16, 50
    hidden = rng.normal(size=(b, t, h)).astype(np.float32)
    w = rng.normal(size=(v, h)).astype(np.float32) * 0.3
    labels = rng.integers(0, v, size=(b, t)).astype(np.int32)
    labels[rng.uniform(size=(b, t)) < 0.6] = -100
    labels[2] = -100                       # a row with no label
    max_valid = 16

    def jax_loss(hd):
        if form == "gathered":
            return jce.gathered_ce_loss(hd, jnp.asarray(w).T, jnp.asarray(labels), max_valid=max_valid)
        return jce.chunked_ce_loss(hd, jnp.asarray(w).T, jnp.asarray(labels), chunk=8)

    (jl, (ja, jn)), jg = jax.value_and_grad(
        lambda hd: (lambda r: (r[0], r[1:]))(jax_loss(hd)), has_aux=True
    )(jnp.asarray(hidden))

    th = torch.from_numpy(hidden).requires_grad_(True)
    tl = torch.from_numpy(labels).long()
    if form == "gathered":
        loss, acc, ntok = ce_loss.gathered_ce_loss(th, torch.from_numpy(w), tl, max_valid=max_valid)
    else:
        loss, acc, ntok = ce_loss.chunked_ce_loss(th, torch.from_numpy(w), tl, chunk=8)
    loss.backward()
    _close(loss.item(), jl)
    _close(acc.item(), ja)
    assert int(ntok) == int(jn) > 0
    _close(th.grad.numpy(), jg, GRAD_TOL)


def _jax_projector_grads(jm, jb):
    def loss_fn(pp):
        return jtasu.forward(jm, {**jm.params, "projector": pp}, jb)[0]

    g = jax.grad(loss_fn)(jm.params["projector"])
    return convert.projector_state_dict(jax.tree_util.tree_map(np.asarray, g))


@pytest.mark.parametrize("case", ["gathered", "full_logits"])
def test_forward_and_projector_grads_match_jax(case, monkeypatch):
    # text 6 over 16 frames: 6 <= (21 - 1) // 2, the gathered CE; text 10
    # over 8 frames: 10 > (17 - 1) // 2, the full-logit CE
    s, a = (6, 16) if case == "gathered" else (10, 8)
    jtc, jm, tc, pm = _pair()
    jb, tb = _batch(s=s, a=a)
    calls = []
    real = tasu.gathered_ce_loss
    monkeypatch.setattr(tasu, "gathered_ce_loss", lambda *a_, **k: calls.append(1) or real(*a_, **k))

    jl, jaux = jtasu.forward(jm, jm.params, jb, None)
    names = tasu.trainable_mask(pm, tc)
    loss, aux = tasu.forward(pm, tb)
    loss.backward()
    assert bool(calls) == (case == "gathered")
    _close(loss.item(), jl)
    _close(aux["acc"].item(), jaux["acc"])
    assert int(aux["ntokens"]) == int(jaux["ntokens"]) > 0

    want = _jax_projector_grads(jm, jb)
    params = dict(pm.named_parameters())
    assert sorted(names) == sorted(f"projector.{k}" for k in want)
    for k, g in want.items():
        _close(params[f"projector.{k}"].grad.numpy(), g.numpy(), GRAD_TOL)
    assert all(p.grad is None for n, p in params.items() if n not in names)


def test_batch_valid_rows_contribute_nothing():
    jtc, jm, tc, pm = _pair()
    jb, tb = _batch()
    valid = np.array([True, False, True])
    jl, jaux = jtasu.forward(jm, jm.params, {**jb, "batch_valid": jnp.asarray(valid)}, None)
    with torch.no_grad():
        loss, aux = tasu.forward(pm, {**tb, "batch_valid": torch.from_numpy(valid)})
    _close(loss.item(), jl)
    assert int(aux["ntokens"]) == int(jaux["ntokens"])


@pytest.mark.parametrize("lr,warmup,total", [(1e-3, 2, 10), (5e-5, 200, 15000), (1e-3, 0, 5)])
def test_warmup_cosine_matches_optax(lr, warmup, total):
    want = jts.warmup_cosine(lr, warmup, total)
    got = warmup_cosine(lr, warmup, total)
    steps = list(range(13)) + [warmup - 1, warmup, warmup + 1, total, total + 50]
    for step in steps:
        _close(got(step), float(want(step)), dict(atol=1e-12, rtol=1e-5))  # optax: fp32
    assert got(0) == 0.0


def test_train_step_matches_jax_over_three_steps():
    train = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.01)
    jtc, jm, tc, pm = _pair(**train)
    jb, tb = _batch()

    trainable = jtasu.trainable_mask(jm, jtc)
    tx, _ = jts.build_optimizer(jtc, trainable)
    state = jts.create_train_state(jm.params, tx, trainable)
    jax_step = jstep.make_train_step(jm, tx, trainable)
    step = make_train_step(pm, tc, device="cpu")
    start = {k: v.clone() for k, v in pm.projector.state_dict().items()}
    key = jax.random.PRNGKey(0)
    losses = []
    for _ in range(3):
        state, jmet = jax_step(state, jb, key)
        met = step(tb)
        _close(met["loss"].item(), jmet["loss"])
        _close(met["acc"].item(), jmet["acc"])
        assert int(met["ntokens"]) == int(jmet["ntokens"])
        losses.append(met["loss"].item())
    assert losses[0] == losses[1] != losses[2]   # lr is 0 at step 0
    want = convert.projector_state_dict(
        jax.tree_util.tree_map(np.asarray, state.params["projector"])
    )
    got = pm.projector.state_dict()
    for k, w in want.items():
        _close(got[k].numpy(), w.numpy(), WEIGHT_TOL)
    # the projector moved
    assert not torch.allclose(got["ffn1.weight"], start["ffn1.weight"])


def test_optimizer_holds_state_for_the_projector_only():
    _, _, tc, pm = _pair(lr=1e-3, warmup_steps=1)
    frozen = {n: p.detach().clone() for n, p in pm.named_parameters()
              if not n.startswith("projector.")}
    _, tb = _batch()
    step = make_train_step(pm, tc, device="cpu")
    step(tb)
    step(tb)
    params = dict(pm.named_parameters())
    assert sorted(step.trainable) == sorted(
        f"projector.{k}" for k in ("norm.weight", "norm.bias", "ffn1.weight",
                                    "ffn1.bias", "ffn2.weight", "ffn2.bias")
    )
    state = step.optimizer.state
    assert len(state) == 6
    assert {id(p) for p in state} == {id(params[n]) for n in step.trainable}
    for n, before in frozen.items():
        assert torch.equal(params[n], before), n
        assert params[n].grad is None and not params[n].requires_grad


def test_eval_step_matches_jax():
    jtc, jm, tc, pm = _pair()
    jb, tb = _batch(seed=3)
    want = jstep.make_eval_step(jm)(jm.params, jb)
    got = make_eval_step(pm, device="cpu")(tb)
    for k in ("loss", "acc"):
        _close(got[k].item(), want[k])
    assert int(got["ntokens"]) == int(want["ntokens"])
    assert not got["loss"].requires_grad


def test_tasu_step_flops_match_jax_at_bench_shapes():
    tc, mc = half_audio_configs()
    kw = dict(batch=BENCH_BATCH, frames=BENCH_FRAMES, text_len=BENCH_TEXT_LEN,
              freeze_llm=tc.freeze_llm, freeze_encoder=tc.freeze_encoder)
    got = flops.tasu_step_flops(
        Qwen2Config.tiny(**QWEN25_1_5B), SenseVoiceConfig.tiny(**SENSEVOICE_SMALL), mc, **kw
    )
    want = jflops.tasu_step_flops(
        jqwen2.Qwen2Config.tiny(**QWEN25_1_5B), jsv.SenseVoiceConfig.tiny(**SENSEVOICE_SMALL),
        JaxModelConfig(encoder_dim=mc.encoder_dim, llm_dim=mc.llm_dim), **kw,
    )
    assert got == want
    assert got["total"] / 1e12 == pytest.approx(17.359, abs=5e-4)
    assert flops.H100_BF16_PEAK_FLOPS == 989e12
