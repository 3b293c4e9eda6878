"""PyTorch port: the projector zoo against the JAX package (CPU).

Each projector is built by the JAX package (``init_projector``), carried
into the port's module by ``convert.projector_state_dict`` and applied to
the same seeded numpy frames.  Gradients are those of ``sum(out * r)`` for
a seeded ``r``, with respect to the input and every weight.

Tolerances (fp32): outputs and gradients 1e-5 (absolute and relative);
the q-former's 2e-5, through 3 post-LN layers whose LayerNorms (eps 1e-12)
divide by small variances.  Key maps and loaded tensors: equal.
About 23 s alone on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_slm_tpu.config import ModelConfig as JaxModelConfig
from ps_slm_tpu.models import projector as jproj
from ps_slm_tpu.training import checkpoint as jckpt
from ps_slm_tpu_torch import convert
from ps_slm_tpu_torch.config import ModelConfig
from ps_slm_tpu_torch.models import projector as proj
from ps_slm_tpu_torch.training import checkpoint as ckpt

ENC, LLM, T = 12, 32, 13
QF = dict(qformer_layers=3, qformer_heads=4, query_len=5)   # at its own widths, 768 / 3072
CASES = {   # name -> (ds_rate, extra config, tolerance)
    "simple_linear": (2, {}, 1e-5),
    "linear": (3, {}, 1e-5),
    "cov1d-linear": (2, {}, 1e-5),
    "cross-attention": (1, dict(ca_heads=4), 1e-5),
    "q-former": (1, QF, 2e-5),
    "linear-silu": (1, {}, 1e-5),
}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(name, seed=0):
    k, extra, _ = CASES[name]
    kw = dict(encoder_projector=name, encoder_dim=ENC, llm_dim=LLM,
              encoder_projector_ds_rate=k, **extra)
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    params = jproj.init_projector(jax.random.PRNGKey(seed), jcfg)
    module = proj.build_projector(cfg)
    module.load_state_dict(convert.projector_state_dict(_numpy(params)))
    return jcfg, params, module


def _inputs(seed=0, t=T):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, t, ENC)).astype(np.float32)
    embed = rng.normal(size=(300, LLM)).astype(np.float32)
    return x, embed


@pytest.mark.parametrize("name", list(CASES))
def test_projector_and_gradients_match_jax(name):
    jcfg, params, module = _pair(name)
    x, embed = _inputs()
    extra = (jnp.asarray(embed),) if name == "cross-attention" else ()

    def jfwd(p, xx):
        return jproj.apply_projector(p, jcfg, xx, *extra)

    want = jax.jit(jfwd)(params, jnp.asarray(x))
    r = np.random.default_rng(9).normal(size=want.shape).astype(np.float32)
    gp, gx = jax.jit(jax.grad(lambda p, xx: jnp.sum(jfwd(p, xx) * r), argnums=(0, 1)))(
        params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = module(xt, torch.tensor(embed)) if extra else module(xt)
    (got * torch.tensor(r)).sum().backward()
    tol = CASES[name][2]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=tol, rtol=tol)
    want_g = convert.projector_state_dict(_numpy(gp))
    for pname, p in module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[pname].numpy(), atol=tol, rtol=tol,
                                   err_msg=pname)
    assert set(want_g) == set(module.state_dict())
    k = CASES[name][0]
    if name in ("simple_linear", "linear", "cov1d-linear"):
        assert got.shape[1] == T // k       # the T % k tail frames dropped


def test_cross_attention_is_independent_of_the_chunk_and_detaches_the_table():
    jcfg, params, module = _pair("cross-attention", seed=1)
    x, embed = _inputs(1)
    want = np.asarray(jproj.apply_cross_attention(params, jcfg, jnp.asarray(x),
                                                  jnp.asarray(embed), chunk=64))
    table = torch.tensor(embed, requires_grad=True)
    outs = [module(torch.tensor(x), table, chunk=c) for c in (1, 7, 64, 300, 8192)]
    for out in outs:
        np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5, rtol=1e-5)
    outs[2].sum().backward()
    assert table.grad is None and module.w_q.weight.grad is not None


def test_qformer_atts_masks_padded_frames():
    """With ``atts`` the padded frames change nothing; JAX's apply_qformer
    with the same mask agrees."""
    jcfg, params, module = _pair("q-former", seed=2)
    x, _ = _inputs(2)
    atts = np.arange(T)[None, :] < np.array([T, 7])[:, None]
    want = np.asarray(jproj.apply_qformer(params, jcfg, jnp.asarray(x), jnp.asarray(atts)))
    got = module(torch.tensor(x), torch.tensor(atts))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5, rtol=2e-5)
    x2 = x.copy()
    x2[1, 7:] = 100.0
    again = module(torch.tensor(x2), torch.tensor(atts))
    torch.testing.assert_close(again, got)
    assert got.shape == (2, QF["query_len"], LLM)


@pytest.mark.parametrize("name", list(CASES))
def test_reference_key_maps_equal_jax(name):
    """projector_to_reference gives the JAX exporter's names and values;
    reference_to_projector loads them back into a fresh module."""
    _, params, module = _pair(name, seed=3)
    want = jckpt.projector_to_reference(params, name)
    got = ckpt.projector_to_reference(module, name)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    _, _, fresh = _pair(name, seed=4)
    state, loaded = ckpt.reference_to_projector(got, name, fresh)
    assert sorted(loaded) == sorted(want)
    fresh.load_state_dict(state)
    for key, value in module.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key
    if name == "q-former":
        layer = "encoder_projector.qformer.encoder.layer.{}.crossattention.attention.key.weight"
        assert layer.format(0) in got and layer.format(1) not in got
        with pytest.raises(ValueError, match="needs the projector"):
            ckpt.reference_to_projector(got, name)


def test_load_ctc_linear_matches_jax(tmp_path):
    _, params, module = _pair("simple_linear", seed=5)
    rng = np.random.default_rng(5)
    w = rng.normal(size=(LLM, ENC * 2)).astype(np.float32)
    b = rng.normal(size=(LLM,)).astype(np.float32)
    path = str(tmp_path / "ctc.pt")
    torch.save({"ctc_head.weight": torch.tensor(w), "ctc_head.bias": torch.tensor(b)}, path)
    want = jckpt.load_ctc_linear(path, params)
    module.load_state_dict(ckpt.load_ctc_linear(path))
    np.testing.assert_array_equal(module.map.weight.detach().numpy(),
                                  np.asarray(want["map"]["kernel"]).T)
    np.testing.assert_array_equal(module.map.bias.detach().numpy(), np.asarray(want["map"]["bias"]))


def test_downsample_rate_and_frame_concat():
    for name, want in (("linear-silu", 1), ("cross-attention", 1), ("linear", 3), ("q-former", 3)):
        cfg = ModelConfig(encoder_projector=name, encoder_projector_ds_rate=3)
        assert proj.downsample_rate(cfg) == want == jproj.downsample_rate(
            JaxModelConfig(encoder_projector=name, encoder_projector_ds_rate=3))
    x = np.arange(2 * 7 * 3, dtype=np.float32).reshape(2, 7, 3)
    np.testing.assert_array_equal(proj.frame_concat(torch.tensor(x), 3).numpy(),
                                  np.asarray(jproj.frame_concat(jnp.asarray(x), 3)))
