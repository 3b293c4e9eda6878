"""PyTorch port: beam search, sampling and ``generate``'s dispatch against
the JAX package (CPU, fp32).

A tiny Qwen2 from the JAX ``init_params``, converted leaf by leaf, decodes
a left-padded batch of 2 from numpy inputs; tokens must be equal.
Sampling takes its Gumbel noise from a hook that replays the JAX key
schedule: the first token draws with the key itself, each later step with
``split(key)``'s second half.  Ties: ``jax.lax.top_k`` puts the lower index
first among equal values, ``torch.topk`` promises nothing, so the port's
top-k helpers are held to ``lax.top_k`` on rows full of ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_slm_tpu.config import ModelConfig as JaxModelConfig
from ps_slm_tpu.config import TrainConfig as JaxTrainConfig
from ps_slm_tpu.inference import generate as jgen
from ps_slm_tpu.models import qwen2 as jqwen2
from ps_slm_tpu.models import tasu as jtasu
from ps_slm_tpu_torch import convert
from ps_slm_tpu_torch.config import ModelConfig, TrainConfig
from ps_slm_tpu_torch.inference import generate as gen
from ps_slm_tpu_torch.models import tasu
from ps_slm_tpu_torch.models.qwen2 import Qwen2Config, Qwen2Model

MAX_NEW = 8
EOS = 5
SPEECH = 250


def _llm(tree=None):
    """(JAX config, numpy param tree, the port's model with its weights)."""
    jcfg = jqwen2.Qwen2Config.tiny()
    if tree is None:
        tree = jax.tree_util.tree_map(np.array, jqwen2.init_params(jax.random.PRNGKey(0), jcfg))
    llm = Qwen2Model(Qwen2Config.tiny())
    llm.load_state_dict(convert.qwen2_state_dict(tree))
    return jcfg, tree, llm.eval()


def _prompt(h, b=2, s=6):
    """Left-padded embeddings: row 1 has two pad positions."""
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(b, s, h)).astype(np.float32)
    mask = np.ones((b, s), bool)
    mask[1, :2] = False
    pos = np.maximum(np.cumsum(mask, 1) - 1, 0).astype(np.int32)
    return emb, mask, pos


def _decode(jax_fn, torch_fn, tree, jcfg, llm, **kw):
    emb, mask, pos = _prompt(jcfg.hidden_size)
    want = np.asarray(jax_fn(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg, jnp.asarray(emb), jnp.asarray(mask),
        jnp.asarray(pos), max_new_tokens=MAX_NEW, **kw))
    got = torch_fn(llm, torch.from_numpy(emb), torch.from_numpy(mask),
                   torch.from_numpy(pos).long(), max_new_tokens=MAX_NEW, **kw)
    return want, got.numpy()


def _counting(monkeypatch):
    steps = []
    real = gen._step
    monkeypatch.setattr(gen, "_step", lambda *a, **k: steps.append(1) or real(*a, **k))
    return steps


def _tie_rows(width, seed=0):
    """Rows of few distinct values: most of each row ties."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=(3, width)).astype(np.float32)


@pytest.mark.parametrize("width,k", [(12, 4), (3000, 8)])
def test_top_k_breaks_ties_as_lax_top_k(width, k):
    x = _tie_rows(width)
    want_v, want_i = (np.asarray(a) for a in jax.lax.top_k(jnp.asarray(x), k))
    fn = gen.top_k if width < 100 else gen.top_k_wide
    got_v, got_i = fn(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    if fn is gen.top_k_wide:
        # torch.topk's own order among the ties is not lax.top_k's
        assert not np.array_equal(torch.topk(torch.from_numpy(x), k).indices.numpy(), want_i)


@pytest.mark.parametrize("case", ["beams4", "beams2", "length_penalty", "min_length",
                                  "repetition_penalty", "eos_banked"])
def test_beam_generate_matches_jax(case, monkeypatch):
    jcfg, tree, llm = _llm()
    kw = {"beams4": dict(num_beams=4), "beams2": dict(num_beams=2),
          "length_penalty": dict(num_beams=4, length_penalty=0.6),
          "min_length": dict(num_beams=4, min_length=3),
          "repetition_penalty": dict(num_beams=4, repetition_penalty=1.3),
          "eos_banked": dict(num_beams=4)}[case]
    if case == "eos_banked":
        # EOS's row of the (tied) head tripled: row 0's best hypothesis
        # ends at step 3 and is banked there, then EOS-filled
        table = tree["embed_tokens"].copy()
        table[EOS] *= 3.0
        jcfg, tree, llm = _llm({**tree, "embed_tokens": table})
    steps = _counting(monkeypatch)
    want, got = _decode(jgen.beam_generate, gen.beam_generate, tree, jcfg, llm,
                        eos_token_id=EOS, **kw)
    np.testing.assert_array_equal(got, want)
    assert len(steps) == MAX_NEW - 1          # no early exit
    if case == "eos_banked":
        assert (want[0, 3:] == EOS).all() and (want[:, :3] != EOS).all()


def _flipped_topk(x, k, dim=-1, largest=True, sorted=True):
    """``torch.topk`` giving the HIGHER index first among equal values."""
    n = x.shape[dim]
    vals, idx = torch.sort(x.flip(dim), dim=dim, descending=largest, stable=True)
    return torch.return_types.topk((vals.narrow(dim, 0, k), n - 1 - idx.narrow(dim, 0, k)))


def test_beam_ties_follow_lax_top_k(monkeypatch):
    """A head with duplicated rows (the tiny model ties head and embedding):
    every token the beams emit has a twin of equal logit, and beams that
    took twins stay equal afterwards.  The tokens still equal JAX's, also
    with a ``torch.topk`` that orders ties the other way."""
    jcfg, tree, llm = _llm()
    first, _ = _decode(jgen.beam_generate, gen.beam_generate, tree, jcfg, llm,
                       eos_token_id=EOS, num_beams=4)
    table = tree["embed_tokens"].copy()
    twins = {}
    for j, tok in enumerate(sorted(set(first.ravel().tolist()))):
        twin = j + 10 if j % 2 else jcfg.vocab_size - 1 - j     # below and above
        table[twin] = table[tok]
        twins[tok] = twin
    jcfg, tree, llm = _llm({**tree, "embed_tokens": table})
    want, got = _decode(jgen.beam_generate, gen.beam_generate, tree, jcfg, llm,
                        eos_token_id=EOS, num_beams=4)
    np.testing.assert_array_equal(got, want)
    # row 0's best first token now ties with its lower-indexed twin
    tok = int(first[0, 0])
    assert want[0, 0] == min(tok, twins[tok]) != tok
    monkeypatch.setattr(torch, "topk", _flipped_topk)
    _, got = _decode(jgen.beam_generate, gen.beam_generate, tree, jcfg, llm,
                     eos_token_id=EOS, num_beams=4)
    np.testing.assert_array_equal(got, want)


@jax.jit
def _jax_gumbel(key, logits):
    return jax.random.gumbel(key, logits.shape, jnp.float32)


def _jax_sample(logits, key, t, seen, *, eos, temperature, top_p, min_length, rp):
    """The filter chain of the JAX ``greedy_generate``'s ``sample_from``
    (jitted with its settings static, as there), then
    ``jax.random.categorical``."""
    @jax.jit
    def run(logits, key, seen):
        if rp != 1.0:
            logits = jnp.where(seen, jnp.where(logits > 0, logits / rp, logits * rp), logits)
        if min_length > 1:
            logits = jnp.where((t < min_length - 1) & (jnp.arange(logits.shape[-1]) == eos)[None],
                               gen.NEG_INF, logits)
        if temperature != 1.0:
            logits = logits / temperature
        if top_p < 1.0:
            srt = jnp.sort(logits, axis=-1)[:, ::-1]
            cum = jnp.cumsum(jax.nn.softmax(srt, axis=-1), axis=-1)
            cutoff = jnp.take_along_axis(srt, jnp.sum(cum < top_p, axis=-1)[:, None], axis=-1)
            logits = jnp.where(logits < cutoff, gen.NEG_INF, logits)
        return jax.random.categorical(key, logits)

    return np.asarray(run(jnp.asarray(logits), key, jnp.asarray(seen)))


@pytest.mark.parametrize("temperature,top_p,min_length,rp,t", [
    (1.0, 1.0, 1, 1.0, 0), (0.7, 1.0, 1, 1.0, 2), (1.0, 0.8, 1, 1.0, 1),
    (1.3, 0.9, 4, 1.3, 1), (1.0, 1.0, 4, 1.3, 5),
])
def test_sample_from_matches_jax_categorical(temperature, top_p, min_length, rp, t):
    rng = np.random.default_rng(1)
    b, v = 6, 1000
    logits = (rng.normal(size=(b, v)) * 3).astype(np.float32)
    logits[:, EOS] += 8.0                     # EOS likely unless masked
    seen = rng.uniform(size=(b, v)) < 0.1
    key = jax.random.PRNGKey(11)
    want = _jax_sample(logits, key, t, seen, eos=EOS, temperature=temperature, top_p=top_p,
                       min_length=min_length, rp=rp)
    got = gen.sample_from(
        torch.from_numpy(logits), t, torch.from_numpy(seen),
        torch.from_numpy(np.array(_jax_gumbel(key, logits))), eos_token_id=EOS,
        do_sample=True, temperature=temperature, top_p=top_p, min_length=min_length,
        repetition_penalty=rp)
    np.testing.assert_array_equal(got.numpy(), want)
    if min_length > 1 and t < min_length - 1:
        assert (want != EOS).all()


def _replayed_gumbel(key, steps, shape):
    """The JAX greedy loop's draws: step 0 from ``key``, step t from the
    second half of the t-th ``split``."""
    keys, k = [key], key
    for _ in range(steps - 1):
        k, sub = jax.random.split(k)
        keys.append(sub)
    return lambda t: torch.from_numpy(np.array(jax.random.gumbel(keys[t], shape, jnp.float32)))


@pytest.mark.parametrize("kw", [
    dict(do_sample=True), dict(do_sample=True, temperature=0.7, top_p=0.8),
    dict(do_sample=True, temperature=1.5, top_p=0.9, min_length=4, repetition_penalty=1.3),
    dict(min_length=3, repetition_penalty=1.3),
])
def test_greedy_sampling_matches_jax_key_schedule(kw):
    jcfg, tree, llm = _llm()
    key = jax.random.PRNGKey(7)
    emb, mask, pos = _prompt(jcfg.hidden_size)
    want = np.asarray(jgen.greedy_generate(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg, jnp.asarray(emb), jnp.asarray(mask),
        jnp.asarray(pos), key, max_new_tokens=MAX_NEW, eos_token_id=EOS, **kw))
    got = gen.greedy_generate(
        llm, torch.from_numpy(emb), torch.from_numpy(mask), torch.from_numpy(pos).long(),
        max_new_tokens=MAX_NEW, eos_token_id=EOS,
        gumbel=_replayed_gumbel(key, MAX_NEW, (2, jcfg.vocab_size)), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gumbel_noise_is_standard_gumbel():
    g = gen.gumbel_noise((200, 1000), torch.Generator().manual_seed(0))
    assert torch.isfinite(g).all()
    assert abs(float(g.mean()) - 0.5772) < 0.01          # Euler-Mascheroni
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.03


def _tasu_pair():
    flags = dict(ctc_posterior=True, do_psd=True)
    jm = jtasu.model_factory(
        JaxTrainConfig(**flags), JaxModelConfig(llm_path="", encoder_dim=11, llm_dim=64),
        rng=jax.random.PRNGKey(0),
    )
    pm = tasu.model_factory(TrainConfig(**flags), ModelConfig(encoder_dim=11, llm_dim=64),
                            device="cpu")
    pm.load_state_dict(convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params)))
    jm.speech_token_id = pm.speech_token_id = SPEECH
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 200, size=(3, 10)).astype(np.int32)
    ids[:, 3] = SPEECH
    batch = {"input_ids": ids, "attention_mask": np.ones((3, 10), bool),
             "input_features": rng.normal(size=(3, 8, 24)).astype(np.float32),
             "input_feature_length": np.array([8, 5, 2], np.int32)}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in ("input_ids", "input_feature_length"):
        tb[k] = tb[k].long()
    return jm, pm, {k: jnp.asarray(v) for k, v in batch.items()}, tb


@pytest.mark.parametrize("mode", ["default_beams", "sampling"])
def test_generate_dispatch_matches_jax(mode):
    """``generate`` with the default ``num_beams`` (4: beam search), and
    ``num_beams=1, do_sample=True`` with the JAX draws fed in."""
    jm, pm, jb, tb = _tasu_pair()
    if mode == "default_beams":
        want = jgen.generate(jm, jm.params, jb, eos_token_id=EOS, max_new_tokens=MAX_NEW)
        got = gen.generate(pm, tb, eos_token_id=EOS, max_new_tokens=MAX_NEW, device="cpu")
    else:
        key = jax.random.PRNGKey(3)
        kw = dict(num_beams=1, do_sample=True, temperature=0.8, max_new_tokens=MAX_NEW)
        want = jgen.generate(jm, jm.params, jb, eos_token_id=EOS, key=key, **kw)
        got = gen.generate(pm, tb, eos_token_id=EOS, device="cpu",
                           gumbel=_replayed_gumbel(key, MAX_NEW, (3, 256)), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
