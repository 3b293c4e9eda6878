"""PyTorch port: models/sensevoice_asr.py against the JAX package (CPU).

A tiny SenseVoice encoder (3 blocks, 16 wide) built by the JAX package and
carried into the port's ``SenseVoiceEncoder`` leaf by leaf with
``convert.encoder_state_dict``; the same seeded numpy features, labels and
targets go through both.  The encoder training step is what
``benchmarks/tasu_transfer.py`` runs: the rich query embeddings prepended,
``encoder_train_loss``, AdamW with warmup-cosine (the port's
``training/train_state.py`` against the JAX ``build_optimizer``).

Tolerances (fp32): losses 1e-5 (absolute and relative); every encoder
leaf's gradient 1e-5 absolute, 1e-4 relative (the gradient passes back
through 3 blocks and the CTC lattice, summed in other orders); weights
after 3 AdamW steps 1e-4 absolute, 1e-5 relative, since the update
g / (|g| + eps) multiplies a gradient's rounding by up to 1 / eps = 1e6
where |g| is below eps.  Token ids, texts and timestamps: equal.
About 38 s alone on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_slm_tpu.config import TrainConfig as JaxTrainConfig
from ps_slm_tpu.data import spm as jspm
from ps_slm_tpu.models import sensevoice as jsv
from ps_slm_tpu.models import sensevoice_asr as jasr
from ps_slm_tpu.training import train_state as jts
from ps_slm_tpu_torch import convert
from ps_slm_tpu_torch.config import TrainConfig
from ps_slm_tpu_torch.data import spm
from ps_slm_tpu_torch.models import sensevoice_asr as asr
from ps_slm_tpu_torch.models.sensevoice import SenseVoiceConfig, SenseVoiceEncoder
from ps_slm_tpu_torch.training.train_state import MultiSteps, build_optimizer, warmup_cosine

RICH = (0, 1, 2, 2)   # the query ids and rich labels of benchmarks/tasu_transfer.py
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
WEIGHT_TOL = dict(atol=1e-4, rtol=1e-5)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(seed=0, **cfg):
    jcfg = jsv.SenseVoiceConfig.tiny(**cfg)
    params = jsv.init_params(jax.random.PRNGKey(seed), jcfg)
    enc = SenseVoiceEncoder(SenseVoiceConfig.tiny(**cfg))
    enc.load_state_dict(convert.encoder_state_dict(_numpy(params)))
    return jcfg, params, enc


def _train_batch(cfg, seed=0, infeasible=False):
    """4 ragged rows of 4 query frames + features; with ``infeasible``, row
    3's 6 targets cannot fit its 4 speech frames."""
    rng = np.random.default_rng(seed)
    b, t, l = 4, 14, 6
    feats = rng.normal(size=(b, t, cfg.input_size)).astype(np.float32)
    flens = np.array([14, 11, 9, 4 if infeasible else 12])
    tlens = np.array([6, 4, 5, 6])
    text = np.zeros((b, 4 + l), np.int32)
    text[:, :4] = RICH
    text[1, 0] = -1                       # an ignored rich label
    for i, n in enumerate(tlens):
        text[i, 4:4 + n] = rng.integers(1, cfg.vocab_size, size=n)
    return feats, flens, text, tlens + 4


def _jax_loss(params, cfg, feats, flens, text, tlens):
    q = jsv.query_embedding(params, list(RICH))
    speech = jnp.concatenate([jnp.broadcast_to(q[None], (feats.shape[0],) + q.shape),
                              feats], axis=1)
    return jasr.encoder_train_loss(params, cfg, speech, flens + 4, text, tlens)


def _port_loss(enc, feats, flens, text, tlens):
    speech, lens = asr.prepend_queries(enc, torch.tensor(feats), torch.tensor(flens), RICH)
    return asr.encoder_train_loss(enc, speech, lens, torch.tensor(text), torch.tensor(tlens))


def test_encoder_train_loss_with_an_infeasible_row_matches_jax():
    """An infeasible row keeps the loss finite (optax's log(0) of -1e5);
    its gradient is ill-conditioned in fp32 (tests/test_torch_ctc.py holds
    it against float64), so here only finiteness."""
    cfg, params, enc = _pair(seed=1)
    batch = _train_batch(cfg, seed=1, infeasible=True)
    want = jax.jit(lambda p: _jax_loss(p, cfg, *batch))(params)
    got = _port_loss(enc, *batch)
    for k in ("loss", "loss_ctc", "loss_rich"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), **TOL)
    assert got["loss_ctc"].item() > 1e5 / 4
    got["loss"].backward()
    assert all(torch.isfinite(p.grad).all() for p in enc.parameters())


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_rich_ce_loss_matches_jax(smoothing):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 4, 30)).astype(np.float32)
    labels = rng.integers(0, 30, size=(3, 4)).astype(np.int32)
    labels[0, 1] = labels[2, 3] = -1
    want = jasr.rich_ce_loss(jnp.asarray(logits), jnp.asarray(labels), smoothing=smoothing)
    got = asr.rich_ce_loss(torch.tensor(logits), torch.tensor(labels), smoothing=smoothing)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    none = asr.rich_ce_loss(torch.tensor(logits), torch.full((3, 4), -1))
    assert none.item() == 0.0


@pytest.mark.parametrize("remat", [False, True])
def test_encoder_train_loss_and_gradients_match_jax(remat):
    cfg, params, enc = _pair()
    batch = _train_batch(cfg)
    (_, want), grads = jax.jit(jax.value_and_grad(
        lambda p: (lambda o: (o["loss"], o))(_jax_loss(p, cfg, *batch)), has_aux=True))(params)
    enc.remat = remat
    got = _port_loss(enc, *batch)
    got["loss"].backward()
    for k in ("loss", "loss_ctc", "loss_rich"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), **TOL)
    want_grads = convert.encoder_state_dict(_numpy(grads))
    for name, p in enc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), **GRAD_TOL,
                                   err_msg=name)


def test_adamw_steps_match_optax():
    cfg, params, enc = _pair(seed=3)
    batch = _train_batch(cfg, seed=3)
    flags = dict(lr=1e-3, warmup_steps=1, total_steps=6, weight_decay=0.01)
    tx, _ = jts.build_optimizer(JaxTrainConfig(**flags))
    opt = tx.init(params)

    @jax.jit
    def jstep(p, o):
        g = jax.grad(lambda q: _jax_loss(q, cfg, *batch)["loss"])(p)
        u, o = tx.update(g, o, p)
        return jax.tree_util.tree_map(lambda a, b: a + b, p, u), o

    tc = TrainConfig(**flags)
    ms = MultiSteps(build_optimizer(enc.parameters(), tc),
                    warmup_cosine(tc.lr, tc.warmup_steps, tc.total_steps))
    for _ in range(3):
        params, opt = jstep(params, opt)
        ms.optimizer.zero_grad(set_to_none=True)
        _port_loss(enc, *batch)["loss"].backward()
        ms.step()
    want = convert.encoder_state_dict(_numpy(params))
    for name, p in enc.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), **WEIGHT_TOL, err_msg=name)
    start = convert.encoder_state_dict(_numpy(jsv.init_params(jax.random.PRNGKey(3), cfg)))
    moved = sum(not torch.equal(p, start[n]) for n, p in enc.state_dict().items())
    assert moved == len(start)


def _tokenizers(vocab):
    pieces = [("<blank>", 0.0, spm.TYPE_CONTROL), ("<unk>", 0.0, spm.TYPE_UNKNOWN),
              ("</s>", 0.0, spm.TYPE_CONTROL)]
    pieces += [(c, -1.0, spm.TYPE_NORMAL) for c in "▁abcdefghijklmnopqrstuvwxyz"]
    pieces += [(f"▁{i}", -2.0, spm.TYPE_NORMAL) for i in range(vocab - len(pieces))]
    blob = spm.serialize_model_proto(pieces)
    return jspm.SentencePieceBPE(blob), spm.SentencePieceBPE(blob)


@pytest.mark.parametrize("ban_emo_unk", [False, True])
def test_inference_with_timestamps_matches_jax(ban_emo_unk):
    """Texts, token ids and timestamps equal JAX's.  The CTC head is scaled
    10x, so that the Viterbi's paths are not near-ties (a random head's
    log-probs are all near -log V, where the two packages' last-bit
    differences would pick other paths), and its bias favours the
    emotion-unk id, so banning it changes the tokens."""
    cfg, params, enc = _pair(seed=5, vocab_size=25055)
    unk = asr.EMO_DICT["unk"]
    head = params["ctc_lo"]
    head["kernel"] = head["kernel"] * 10
    head["bias"] = (head["bias"] * 10).at[unk].add(18.0)
    enc.load_state_dict(convert.encoder_state_dict(_numpy(params)))
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(3, 20, cfg.input_size)).astype(np.float32)
    lens = np.array([20, 13, 6])
    jtok, tok = _tokenizers(cfg.vocab_size)
    kw = dict(language="en", use_itn=True, ban_emo_unk=ban_emo_unk, output_timestamp=True,
              keys=["a", "b", "c"])
    want = jasr.inference(params, cfg, jtok, jnp.asarray(feats), jnp.asarray(lens), **kw)
    got = asr.inference(enc, tok, torch.tensor(feats), torch.tensor(lens), device="cpu", **kw)
    assert got == want
    assert sum(len(r["timestamp"]) for r in got) > 3
    has_unk = any(str(unk - 30) in r["text"].split() for r in got)   # piece "▁<id - 30>"
    assert has_unk != ban_emo_unk
