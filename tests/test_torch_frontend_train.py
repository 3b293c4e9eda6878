"""PyTorch port: the training front end (dither, SpecAugment) against the
JAX package's, on the CPU in fp32.

torch's generators cannot reproduce ``jax.random``, so the port takes its
draws as a ``FrontendDraws`` and the tests feed it the JAX draws,
recomputed from the key the JAX training step uses: ``fold_in(fold_in(
PRNGKey(seed), step), 1)`` for the dither noise, ``fold_in`` of that by 7,
then ``split``, for SpecAugment.  Masks are compared exactly; log-mel
values within 1e-3 (the port's float64 fbank against the JAX package's
fp32 one, as in ``test_torch_fbank.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_slm_tpu import config as jconfig
from ps_slm_tpu.ops import fbank as jfb
from ps_slm_tpu_torch import config
from ps_slm_tpu_torch.ops import fbank as fb

ATOL = 1e-3
LENS = (16000, 12345, 3000, 399)     # the last row is under one 400-sample frame
SEED, STEP = 3, 5
SPECAUG = dict(specaug=True, specaug_t_masks=2, specaug_t_width=5, specaug_f_masks=2,
               specaug_f_width=10)


def _waves(n=16000, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(len(LENS), n)) * 0.1).astype(np.float32)
    w += 0.3 * np.sin(np.arange(n) / 7.0).astype(np.float32)
    w[np.arange(n)[None] >= np.asarray(LENS)[:, None]] = 0.0
    return w, np.asarray(LENS, np.int32)


def _cmvn(d=560, seed=1):
    rng = np.random.default_rng(seed)
    return (-(12.0 + rng.normal(size=d))).astype(np.float32), (
        0.25 + 0.05 * rng.random(size=d)).astype(np.float32)


def _dither_key(seed=SEED, step=STEP):
    """The JAX train step's front-end key: the step folded into the run's
    key, then 1 (``models/tasu.py::compute_audio_embeds``)."""
    return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), step), 1)


def jax_draws(w, lens, cfg, key=None) -> fb.FrontendDraws:
    """The draws of the JAX ``frontend(train=True)`` under ``key``, as the
    JAX functions make them."""
    key = _dither_key() if key is None else key
    frame_len = cfg.sample_rate * cfg.frame_length // 1000
    t, _ = fb.framing(w.shape[1], torch.as_tensor(lens), frame_len,
                      cfg.sample_rate * cfg.frame_shift // 1000)
    noise = None
    if cfg.dither > 0.0:
        noise = torch.from_numpy(np.array(
            jax.random.normal(key, (w.shape[0], t, frame_len))))
    if not cfg.specaug:
        return fb.FrontendDraws(noise)
    _, flens = jfb.fbank(jnp.asarray(w), jnp.asarray(lens))
    _, lfr_lens = jfb.lfr(jnp.zeros(flens.shape + (t, 1)), flens, cfg.lfr_m, cfg.lfr_n)
    kt, kf = jax.random.split(jax.random.fold_in(key, 7))
    b, d = w.shape[0], cfg.num_mel_bins * cfg.lfr_m

    def draw(k, count, limit, width):
        starts = jax.random.randint(k, (b, count), 0, jnp.maximum(limit, 1))
        widths = jax.random.randint(jax.random.fold_in(k, 1), (b, count), 0, width + 1)
        return torch.from_numpy(np.array(starts)), torch.from_numpy(np.array(widths))

    t_starts, t_widths = draw(kt, cfg.specaug_t_masks, lfr_lens[:, None], cfg.specaug_t_width)
    f_starts, f_widths = draw(kf, cfg.specaug_f_masks, d, cfg.specaug_f_width)
    return fb.FrontendDraws(noise, t_starts, t_widths, f_starts, f_widths)


def _cfgs(**kw):
    return config.FbankConfig(**kw), jconfig.FbankConfig(**kw)


@pytest.mark.parametrize("dither", [0.001, 1.0])
def test_fbank_dither_equals_jax(dither):
    w, lens = _waves()
    key = _dither_key()
    cfg, _ = _cfgs(dither=dither)
    noise = jax_draws(w, lens, cfg, key).dither
    assert noise.dtype == torch.float32 and noise.shape == (len(LENS), 98, 400)
    got, glen = fb.fbank(torch.from_numpy(w), torch.from_numpy(lens), dither=dither, noise=noise)
    want, wlen = jfb.fbank(jnp.asarray(w), jnp.asarray(lens), key, dither=dither)
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    plain, _ = fb.fbank(torch.from_numpy(w), torch.from_numpy(lens))
    assert (got - plain).abs().max() > 1e-3      # the noise acted


def test_spec_augment_equals_jax_exactly():
    rng = np.random.default_rng(4)
    lens = np.asarray([40, 23, 1, 0], np.int32)
    feats = rng.normal(size=(4, 40, 560)).astype(np.float32) + 5.0   # no zero by chance
    key = jax.random.fold_in(_dither_key(), 7)
    want = jfb.spec_augment(jnp.asarray(feats), jnp.asarray(lens), key, num_t_masks=3,
                            t_width=8, num_f_masks=2, f_width=10)
    kt, kf = jax.random.split(key)
    ints = lambda k, shape, hi: torch.from_numpy(np.array(jax.random.randint(k, shape, 0, hi)))
    draws = fb.FrontendDraws(
        None, ints(kt, (4, 3), jnp.maximum(jnp.asarray(lens)[:, None], 1)),
        ints(jax.random.fold_in(kt, 1), (4, 3), 9), ints(kf, (4, 2), 560),
        ints(jax.random.fold_in(kf, 1), (4, 2), 11))
    got = fb.spec_augment(torch.from_numpy(feats), torch.from_numpy(lens), draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == 0).any() and not (got[1, 23:] == 0).all()   # no time mask past a row's length


@pytest.mark.parametrize("specaug", [False, True])
def test_train_frontend_equals_jax(specaug):
    w, lens = _waves()
    cmvn = _cmvn()
    over = SPECAUG if specaug else {}
    cfg, jcfg = _cfgs(**over)
    draws = jax_draws(w, lens, cfg)
    got, glen = fb.frontend(torch.from_numpy(w), torch.from_numpy(lens), cfg=cfg,
                            cmvn=tuple(map(torch.from_numpy, cmvn)), train=True, draws=draws)
    want, wlen = jfb.frontend(jnp.asarray(w), jnp.asarray(lens), _dither_key(), cfg=jcfg,
                              cmvn=cmvn, train=True)
    want = np.asarray(want)
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)      # the masks, exactly
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert (want == 0).any() == specaug


def test_eval_front_end_draws_nothing():
    """train=False: no dither and no masks, whatever the config asks; no
    generator is needed and the output is the eval front end's."""
    w, lens = _waves()
    cfg, jcfg = _cfgs(dither=1.0, **SPECAUG)
    got, _ = fb.frontend(torch.from_numpy(w), torch.from_numpy(lens), cfg=cfg)
    want, _ = jfb.frontend(jnp.asarray(w), jnp.asarray(lens), _dither_key(), cfg=jcfg)
    plain, _ = fb.frontend(torch.from_numpy(w), torch.from_numpy(lens))
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="generator or draws"):
        fb.frontend(torch.from_numpy(w), torch.from_numpy(lens), cfg=cfg, train=True)


def test_port_draws_stay_in_range():
    w, lens = _waves()
    cfg, _ = _cfgs(**SPECAUG)
    lfr_lens = [-(-max(1 + (n - 400) // 160, 0) // 6) for n in LENS]
    for seed in range(20):
        g = torch.Generator().manual_seed(seed)
        d = fb.frontend_draws(torch.from_numpy(w), torch.from_numpy(lens), g, cfg)
        assert d.dither.shape == (len(LENS), 98, 400) and d.dither.dtype == torch.float32
        assert d.t_starts.shape == d.t_widths.shape == (len(LENS), 2)
        assert d.f_starts.shape == d.f_widths.shape == (len(LENS), 2)
        assert (d.t_widths >= 0).all() and (d.t_widths <= cfg.specaug_t_width).all()
        assert (d.f_widths >= 0).all() and (d.f_widths <= cfg.specaug_f_width).all()
        assert (d.f_starts >= 0).all() and (d.f_starts < 560).all()
        for row, n in enumerate(lfr_lens):
            assert (d.t_starts[row] >= 0).all() and (d.t_starts[row] < max(n, 1)).all()
    a = fb.frontend_draws(torch.from_numpy(w), torch.from_numpy(lens),
                          torch.Generator().manual_seed(7), cfg)
    b = fb.frontend_draws(torch.from_numpy(w), torch.from_numpy(lens),
                          torch.Generator().manual_seed(7), cfg)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    out, _ = fb.frontend(torch.from_numpy(w), torch.from_numpy(lens), cfg=cfg, train=True,
                         generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all() and (out == 0).any()


def test_recipe_default_draws_dither_and_no_mask():
    """The recipes' FbankConfig: dither 0.001, specaug off."""
    cfg = config.FbankConfig()
    assert cfg.dither == 0.001 and not cfg.specaug
    w, lens = _waves()
    d = fb.frontend_draws(torch.from_numpy(w), torch.from_numpy(lens),
                          torch.Generator().manual_seed(0), cfg)
    assert d.dither is not None and d.t_starts is None and d.f_starts is None
    assert fb.frontend_draws(torch.from_numpy(w), torch.from_numpy(lens),
                             torch.Generator().manual_seed(0),
                             dataclasses.replace(cfg, dither=0.0)) == fb.FrontendDraws()
    with pytest.raises(ValueError, match="lack"):
        fb.frontend(torch.from_numpy(w), torch.from_numpy(lens), cfg=cfg, train=True,
                    draws=fb.FrontendDraws())


def test_training_forward_through_the_front_end_equals_jax():
    """``tasu.forward(train=True)`` on an int16 waveform batch with the JAX
    step's front-end draws: loss and accuracy of the JAX forward under the
    same key (no PSD: its argmax would turn the front end's 1e-4 into a
    discrete choice)."""
    from ps_slm_tpu.config import ModelConfig as JaxModelConfig
    from ps_slm_tpu.config import TrainConfig as JaxTrainConfig
    from ps_slm_tpu.models import tasu as jtasu
    from ps_slm_tpu_torch import convert
    from ps_slm_tpu_torch.models import tasu

    flags = dict(ctc_posterior=True, do_psd=False, freeze_llm=True, freeze_encoder=True)
    over = {"input_size": 560}
    jm = jtasu.model_factory(JaxTrainConfig(**flags), JaxModelConfig(
        encoder_dim=11, llm_dim=64, encoder_config_overrides=over), rng=jax.random.PRNGKey(0))
    pm = tasu.model_factory(config.TrainConfig(**flags), config.ModelConfig(
        encoder_dim=11, llm_dim=64, encoder_config_overrides=over), device="cpu")
    pm.load_state_dict(convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params)))
    cfg, jcfg = _cfgs(dither=1.0, **SPECAUG)
    pm.fbank_cfg, jm.fbank_cfg = cfg, jcfg
    pm.cmvn = jm.cmvn = _cmvn()
    jm.speech_token_id = pm.speech_token_id = 250

    w, lens = _waves()
    w16 = np.clip(np.rint(w * 32768.0), -32768, 32767).astype(np.int16)
    rng = np.random.default_rng(5)
    ids = rng.integers(1, 200, size=(len(LENS), 6)).astype(np.int32)
    ids[:, 2] = 250
    labels = ids.copy()
    labels[:, :3] = -100
    batch = {"waveform": w16, "waveform_length": lens, "input_ids": ids,
             "attention_mask": np.ones(ids.shape, bool), "labels": labels}
    run_key = jax.random.fold_in(jax.random.PRNGKey(SEED), STEP)
    want, jaux = jtasu.forward(jm, jm.params, {k: jnp.asarray(v) for k, v in batch.items()},
                               run_key, train=True)
    draws = jax_draws(w16.astype(np.float32) / 32768.0, lens, cfg)
    got, aux = tasu.forward(pm, {k: torch.from_numpy(v) for k, v in batch.items()},
                            train=True, draws=draws)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4, atol=1e-4)
    assert float(aux["acc"]) == pytest.approx(float(jaux["acc"]), abs=1e-6)
    with pytest.raises(TypeError, match="FrontendDraws"):
        from ps_slm_tpu_torch.ops.pseudo_posterior import NoiseDraws

        tasu.forward(pm, {k: torch.from_numpy(v) for k, v in batch.items()},
                     draws=NoiseDraws(torch.zeros(1), torch.zeros(1)))
