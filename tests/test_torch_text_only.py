"""PyTorch port: text-only TASU (the paper's recipe) against the JAX package.

The CTC posterior is simulated from transcript ids (``gt_ids``,
``gt_lens``): a clean one-hot when generating, CPS noise in training.  The
JAX noise draws from ``jax.random`` inside ``pseudo_posterior_noise``; the
port splits the draws from the transform, so these tests recompute the JAX
draws from the same key through the same ``split`` tree and feed them in.
Tiny models converted leaf by leaf, inputs from numpy, fp32; tolerances as
in ``test_torch_train.py``: 1e-5 for losses and gradients here (the
projector sits right after the posterior), 1e-4 absolute for projector
weights after AdamW steps.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_slm_tpu.config import ModelConfig as JaxModelConfig
from ps_slm_tpu.config import TrainConfig as JaxTrainConfig
from ps_slm_tpu.inference.generate import generate as jax_generate
from ps_slm_tpu.models import tasu as jtasu
from ps_slm_tpu.ops import pseudo_posterior as jpp
from ps_slm_tpu.training import step as jstep
from ps_slm_tpu.training import train_state as jts
from ps_slm_tpu_torch import convert
from ps_slm_tpu_torch.config import ModelConfig, TrainConfig, text_only_configs
from ps_slm_tpu_torch.inference.generate import generate
from ps_slm_tpu_torch.models import tasu
from ps_slm_tpu_torch.ops import pseudo_posterior as pp
from ps_slm_tpu_torch.training.step import make_eval_step, make_train_step

SPEECH = 250
ENC_VOCAB, LLM_DIM = 11, 64
TOL = dict(atol=1e-5, rtol=1e-5)
WEIGHT_TOL = dict(atol=1e-4, rtol=1e-5)
TEXT_ONLY = dict(ctc_posterior=True, gt_emb=True, gt_emb_noise=True, do_psd=True,
                 freeze_llm=True, freeze_encoder=True)


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_draws(key, b, length, insert_prob=0.0, smooth_low=0.0, smooth_high=0.1):
    """The draws of the JAX ``pseudo_posterior_noise(key)``, as NoiseDraws."""
    k_alpha, k_drop, k_ins = jax.random.split(key, 3)
    alpha = jax.random.uniform(k_alpha, (b, 1, 1), minval=smooth_low, maxval=smooth_high)
    u_drop = jax.random.uniform(k_drop, (b, length))
    m = math.ceil(length * insert_prob)
    if m == 0:
        return pp.NoiseDraws(_t(alpha), _t(u_drop))
    k_pos, k_jit, k_type = jax.random.split(k_ins, 3)
    return pp.NoiseDraws(
        _t(alpha), _t(u_drop), _t(jax.random.uniform(k_pos, (b, m))),
        _t(jax.random.uniform(k_jit, (b, m), minval=0.05, maxval=0.45)),
        _t(jax.random.uniform(k_type, (b, m))),
    )


def _ids(b=4, length=20, vocab=ENC_VOCAB, lens=(20, 13, 1, 0), seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(b, length)).astype(np.int32), np.array(lens, np.int32)


def test_pseudo_posterior_is_exact():
    ids, lens = _ids()
    ids[0, 5] = -1                        # out of range: a zero row, as jax.nn.one_hot
    want, wl = jpp.pseudo_posterior(jnp.asarray(ids), jnp.asarray(lens), vocab_size=ENC_VOCAB)
    got, gl = pp.pseudo_posterior(_t(ids).long(), _t(lens).long(), ENC_VOCAB)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


@pytest.mark.parametrize("insert_prob", [0.0, 0.2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pseudo_posterior_noise_with_jax_draws_is_exact(insert_prob, seed):
    ids, lens = _ids(seed=seed)
    key = jax.random.PRNGKey(seed)
    kw = dict(vocab_size=ENC_VOCAB, drop_prob=0.3, insert_prob=insert_prob, blank_id=0)
    want, wl = jpp.pseudo_posterior_noise(jnp.asarray(ids), jnp.asarray(lens), key, **kw)
    got, gl = pp.pseudo_posterior_noise(
        _t(ids).long(), _t(lens).long(), jax_draws(key, 4, 20, insert_prob), **kw)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if insert_prob:
        assert (gl > _t(lens).clamp(max=19) * 0.5).any()      # frames were inserted


def test_torch_draws_fall_in_range_and_keep_the_rate():
    g = torch.Generator().manual_seed(0)
    b, length, insert_prob = 64, 512, 0.1
    d = pp.noise_draws(b, length, g, insert_prob=insert_prob, smooth_low=0.02, smooth_high=0.1)
    m = pp.insert_budget(length, insert_prob)
    assert d.alpha.shape == (b, 1, 1) and d.u_drop.shape == (b, length)
    assert all(x.shape == (b, m) for x in (d.u_pos, d.jitter, d.u_type))
    assert 0.02 <= float(d.alpha.min()) and float(d.alpha.max()) < 0.1
    for u in (d.u_drop, d.u_pos, d.u_type):
        assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert 0.05 <= float(d.jitter.min()) and float(d.jitter.max()) < 0.45
    ids = torch.randint(0, ENC_VOCAB, (b, length), generator=g)
    lens = torch.full((b,), length)
    post, new_lens = pp.pseudo_posterior_noise(
        ids, lens, pp.noise_draws(b, length, g), vocab_size=ENC_VOCAB, drop_prob=0.05)
    assert abs(float(new_lens.sum()) / (b * length) - 0.95) < 0.005
    valid = torch.arange(length)[None] < new_lens[:, None]
    np.testing.assert_allclose(post.sum(-1)[valid].numpy(), 1.0, atol=1e-5)
    assert not post[~valid].any()
    assert pp.noise_draws(2, 8, g).u_pos is None       # insert_prob 0: no insertion draws


def _pair(**train):
    flags = dict(TEXT_ONLY, **train)
    jtc = JaxTrainConfig(**flags)
    jm = jtasu.model_factory(
        jtc, JaxModelConfig(llm_path="", encoder_dim=ENC_VOCAB, llm_dim=LLM_DIM),
        rng=jax.random.PRNGKey(0),
    )
    tc = TrainConfig(**flags)
    pm = tasu.model_factory(tc, ModelConfig(encoder_dim=ENC_VOCAB, llm_dim=LLM_DIM), device="cpu")
    pm.load_state_dict(convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params)))
    jm.speech_token_id = pm.speech_token_id = SPEECH
    return jtc, jm, tc, pm


def _batch(b=3, s=6, length=16, gt_lens=(16, 11, 4), seed=0, labels=True):
    """A speech token at 3, the first two labels ignored, ragged gt rows."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 200, size=(b, s)).astype(np.int32)
    ids[:, 3] = SPEECH
    batch = {
        "input_ids": ids, "attention_mask": np.ones((b, s), bool),
        "gt_ids": rng.integers(1, ENC_VOCAB, size=(b, length)).astype(np.int32),
        "gt_lens": np.array(gt_lens, np.int32),
    }
    if labels:
        batch["labels"] = ids.copy()
        batch["labels"][:, :2] = -100
    tb = {k: _t(v) for k, v in batch.items()}
    for k in ("input_ids", "labels", "gt_ids", "gt_lens"):
        if k in tb:
            tb[k] = tb[k].long()
    return {k: jnp.asarray(v) for k, v in batch.items()}, tb


def test_text_only_configs_build_the_published_recipe():
    tc, mc = text_only_configs(dict(num_blocks=1, tp_blocks=1, input_size=24, output_size=16,
                                    attention_heads=2, linear_units=32, vocab_size=ENC_VOCAB),
                               dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                                    num_hidden_layers=1, num_attention_heads=4,
                                    num_key_value_heads=2, head_dim=16))
    model = tasu.model_factory(tc, mc, device="cpu")
    f = model.flags
    assert f.gt_emb and f.gt_emb_noise and f.ctc_posterior and not f.needs_encoder
    assert (f.drop_prob, f.insert_prob, f.smooth_low, f.smooth_high) == (0.05, 0.0, 0.0, 0.1)
    assert (tc.lr, tc.warmup_steps, tc.total_steps) == (5e-5, 200, 15000)
    assert tc.freeze_llm and tc.freeze_encoder and not tc.freeze_projector


@pytest.mark.parametrize("insert_prob", [0.0, 0.2])
def test_text_only_forward_and_projector_grads_match_jax(insert_prob):
    jtc, jm, tc, pm = _pair(insert_prob=insert_prob)
    jb, tb = _batch()
    key = jax.random.PRNGKey(4)

    def loss_fn(proj):
        return jtasu.forward(jm, {**jm.params, "projector": proj}, jb, key)

    (jl, jaux), jg = jax.value_and_grad(loss_fn, has_aux=True)(jm.params["projector"])
    names = tasu.trainable_mask(pm, tc)
    loss, aux = tasu.forward(pm, tb, draws=jax_draws(key, 3, 16, insert_prob))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    np.testing.assert_allclose(aux["acc"].item(), float(jaux["acc"]), **TOL)
    assert int(aux["ntokens"]) == int(jaux["ntokens"]) > 0
    want = convert.projector_state_dict(jax.tree_util.tree_map(np.asarray, jg))
    params = dict(pm.named_parameters())
    assert sorted(names) == sorted(f"projector.{k}" for k in want)
    for k, g in want.items():
        np.testing.assert_allclose(params[f"projector.{k}"].grad.numpy(), g.numpy(), **TOL)


def test_text_only_train_step_matches_jax_over_three_steps():
    jtc, jm, tc, pm = _pair(lr=1e-3, warmup_steps=2, total_steps=10, insert_prob=0.1)
    jb, tb = _batch()
    trainable = jtasu.trainable_mask(jm, jtc)
    tx, _ = jts.build_optimizer(jtc, trainable)
    state = jts.create_train_state(jm.params, tx, trainable)
    jax_step = jstep.make_train_step(jm, tx, trainable)
    step = make_train_step(pm, tc, device="cpu")
    key = jax.random.PRNGKey(0)
    for i in range(3):
        state, jmet = jax_step(state, jb, key)
        # the JAX step draws from fold_in(key, step)
        met = step(tb, draws=jax_draws(jax.random.fold_in(key, i), 3, 16, 0.1))
        np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]), **TOL)
        np.testing.assert_allclose(met["acc"].item(), float(jmet["acc"]), **TOL)
        assert int(met["ntokens"]) == int(jmet["ntokens"])
    want = convert.projector_state_dict(
        jax.tree_util.tree_map(np.asarray, state.params["projector"]))
    for k, w in want.items():
        np.testing.assert_allclose(pm.projector.state_dict()[k].numpy(), w.numpy(), **WEIGHT_TOL)


def test_text_only_eval_is_fixed_and_train_steps_draw_from_their_seed():
    _, _, tc, pm = _pair()
    _, tb = _batch()
    evals = [make_eval_step(pm, device="cpu")(tb) for _ in range(2)]
    for k in ("loss", "acc", "ntokens"):
        assert torch.equal(evals[0][k], evals[1][k])
    # two steps from the same seed draw the same noise (lr 0 at step 0:
    # the weights stay); one step's generator moves on between calls
    losses = [make_train_step(pm, tc, device="cpu")(tb)["loss"] for _ in range(2)]
    assert torch.equal(losses[0], losses[1])
    step = make_train_step(pm, tc, device="cpu")
    assert not torch.equal(step(tb)["loss"], step(tb)["loss"])


def test_text_only_generate_uses_the_clean_one_hot():
    """Generate takes the clean one-hot (no noise), with the default beams
    and greedy; equal tokens to the JAX generate."""
    jtc, jm, tc, pm = _pair()
    jb, tb = _batch(labels=False)
    for beams in (4, 1):
        want = jax_generate(jm, jm.params, jb, eos_token_id=5, num_beams=beams, max_new_tokens=8)
        got = generate(pm, tb, eos_token_id=5, num_beams=beams, max_new_tokens=8, device="cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
