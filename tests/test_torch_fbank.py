"""PyTorch port: the on-device front end (fbank, LFR, CMVN) against the
JAX package's, on the CPU in fp32.

The FFTs of the two libraries round differently, so log-mel values (up to
~26) agree within atol 1e-3, not bit for bit; frame counts and lengths are
equal.  Waveforms come from a numpy seed, on both wire formats (int16 and
fp32), ragged, with a row shorter than one 25 ms frame.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_slm_tpu import config as jconfig
from ps_slm_tpu.ops import fbank as jfb
from ps_slm_tpu_torch import config
from ps_slm_tpu_torch.ops import fbank as fb

ATOL = 1e-3
LENS = (16000 * 2, 23456, 401, 399, 0)    # two rows under one 400-sample frame


def _waves(wire, n=16000 * 2, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(len(LENS), n)) * 0.1).astype(np.float32)
    w += 0.3 * np.sin(np.arange(n) / 7.0).astype(np.float32)
    w[np.arange(n)[None] >= np.asarray(LENS)[:, None]] = 0.0
    if wire == "int16":
        w = np.clip(np.rint(w * 32768.0), -32768, 32767).astype(np.int16)
    return w, np.asarray(LENS, np.int32)


def _cmvn(d=560, seed=1):
    rng = np.random.default_rng(seed)
    return (-(12.0 + rng.normal(size=d))).astype(np.float32), (
        0.25 + 0.05 * rng.random(size=d)).astype(np.float32)


def test_mel_banks_and_windows_equal_jax():
    assert np.array_equal(fb.mel_banks(), jfb.mel_banks())
    assert np.array_equal(fb.mel_banks(40, 512, 8000, 20.0, -400.0),
                          jfb.mel_banks(40, 512, 8000, 20.0, -400.0))
    for w in ("hamming", "hanning", "povey", "rectangular"):
        assert np.array_equal(fb._window(400, w), jfb._window(400, w))


@pytest.mark.parametrize("window", ["hamming", "povey"])
def test_fbank_equals_jax(window):
    w, lens = _waves("float32")
    got, glen = fb.fbank(torch.from_numpy(w), torch.from_numpy(lens), window_type=window)
    want, wlen = jfb.fbank(jnp.asarray(w), jnp.asarray(lens), window_type=window)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("m,n", [(7, 6), (5, 3)])
def test_lfr_equals_jax_exactly(m, n):
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(4, 23, 3)).astype(np.float32)
    lens = np.asarray([23, 17, 1, 0], np.int32)
    got, glen = fb.lfr(torch.from_numpy(feats), torch.from_numpy(lens), m, n)
    want, wlen = jfb.lfr(jnp.asarray(feats), jnp.asarray(lens), m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))


def test_load_and_apply_cmvn_equal_jax(tmp_path):
    neg, inv = _cmvn(7)
    path = tmp_path / "am.mvn"
    path.write_text("<Nnet>\n<Splice> 7 7\n[ 0 ]\n<AddShift> 7 7\n<LearnRateCoef> 0 [ "
                    + " ".join(map(str, neg)) + " ]\n<Rescale> 7 7\n<LearnRateCoef> 0 [ "
                    + " ".join(map(str, inv)) + " ]\n</Nnet>\n")
    for a, b in zip(fb.load_cmvn(str(path)), jfb.load_cmvn(str(path))):
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(3).normal(size=(2, 4, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        fb.apply_cmvn(torch.from_numpy(x), neg, inv).numpy(),
        np.asarray(jfb.apply_cmvn(jnp.asarray(x), neg, inv)))


@pytest.mark.parametrize("wire", ["int16", "float32"])
@pytest.mark.parametrize("with_cmvn", [False, True])
def test_frontend_equals_jax(wire, with_cmvn):
    w, lens = _waves(wire)
    cmvn = _cmvn() if with_cmvn else None
    got, glen = fb.frontend(torch.from_numpy(w), torch.from_numpy(lens), cfg=config.FbankConfig(),
                            cmvn=None if cmvn is None else tuple(map(torch.from_numpy, cmvn)))
    want, wlen = jfb.frontend(jnp.asarray(w), jnp.asarray(lens), cfg=jconfig.FbankConfig(),
                              cmvn=cmvn)
    assert got.shape == want.shape == (len(LENS), -(-((32000 - 400) // 160 + 1) // 6), 560)
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))
    assert glen.tolist()[2:] == [1, 0, 0]
    # CMVN scales log-mel by ~0.25-0.3, so the tolerance holds on the features
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_int16_wire_is_exact_for_16_bit_sources():
    w16, lens = _waves("int16")
    wf = (w16.astype(np.float32) / 32768.0)
    a, _ = fb.frontend(torch.from_numpy(w16), torch.from_numpy(lens))
    b, _ = fb.frontend(torch.from_numpy(wf), torch.from_numpy(lens))
    assert torch.equal(a, b)


def test_training_front_end_names_its_roadmap_item():
    """The training front end is ported (tests/test_torch_frontend_train.py
    holds it against the JAX one): with dither configured it needs a
    generator or draws; with neither dither nor SpecAugment it is the eval
    front end."""
    w, lens = _waves("int16")
    with pytest.raises(ValueError, match="generator or draws"):
        fb.frontend(torch.from_numpy(w), torch.from_numpy(lens), train=True)
    cfg = config.FbankConfig(dither=0.0)
    out, _ = fb.frontend(torch.from_numpy(w), torch.from_numpy(lens), cfg=cfg, train=True)
    assert torch.isfinite(out).all()
    assert torch.equal(out, fb.frontend(torch.from_numpy(w), torch.from_numpy(lens))[0])
    out, _ = fb.frontend(torch.from_numpy(w), torch.from_numpy(lens), train=True,
                         generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all()


def _model_pair(do_psd):
    import jax

    from ps_slm_tpu.config import ModelConfig as JaxModelConfig
    from ps_slm_tpu.config import TrainConfig as JaxTrainConfig
    from ps_slm_tpu.models import tasu as jtasu
    from ps_slm_tpu_torch import convert
    from ps_slm_tpu_torch.models import tasu

    flags = dict(ctc_posterior=True, do_psd=do_psd)
    over = {"input_size": 560}
    jm = jtasu.model_factory(JaxTrainConfig(**flags), JaxModelConfig(
        encoder_dim=11, llm_dim=64, encoder_config_overrides=over), rng=jax.random.PRNGKey(0))
    pm = tasu.model_factory(config.TrainConfig(**flags), config.ModelConfig(
        encoder_dim=11, llm_dim=64, encoder_config_overrides=over), device="cpu")
    pm.load_state_dict(convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params)))
    return jm, pm


def test_waveform_batch_through_the_model_equals_jax():
    """compute_audio_embeds on int16 waveforms: the front end, the model's
    CMVN, the encoder and the projector (no PSD: its argmax would turn the
    front end's 1e-4 into a discrete choice)."""
    from ps_slm_tpu.models import tasu as jtasu
    from ps_slm_tpu_torch.models import tasu

    jm, pm = _model_pair(do_psd=False)
    cmvn = _cmvn()
    jm.cmvn = cmvn
    pm.cmvn = cmvn
    assert pm.cmvn[0].dtype == torch.float32 and pm.cmvn[0].device.type == "cpu"
    w, lens = _waves("int16")
    want, wlen = jtasu.compute_audio_embeds(
        jm, jm.params, {"waveform": jnp.asarray(w), "waveform_length": jnp.asarray(lens)}, None,
        generate_mode=True)
    with torch.no_grad():
        got, glen = tasu.compute_audio_embeds(
            pm, {"waveform": torch.from_numpy(w), "waveform_length": torch.from_numpy(lens)},
            generate_mode=True)
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    # the training forward dithers: from the step's generator
    batch = {"waveform": torch.from_numpy(w), "waveform_length": torch.from_numpy(lens),
             "input_ids": torch.zeros(len(LENS), 4, dtype=torch.long),
             "attention_mask": torch.ones(len(LENS), 4, dtype=torch.bool),
             "labels": torch.zeros(len(LENS), 4, dtype=torch.long)}
    with pytest.raises(ValueError, match="generator or draws"):
        tasu.forward(pm, batch, train=True)
    loss, _ = tasu.forward(pm, batch, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(loss)
    pm.cmvn = None
    assert pm.cmvn is None
