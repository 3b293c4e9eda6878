"""PyTorch port: the greedy, speculative and beam slot pools against the
JAX package's pools and the static decoders.

A tiny Qwen2 (JAX weights, converted) serves ragged requests whose merged
prefills are given directly (``merge`` in the port, ``_merged_jit`` in the
JAX package), more requests than slots.  Each request's tokens must equal
the JAX pool's and the port's static decoder's on the same left-padded
prefill (fp32, exact), and the port must launch as many chunks as the JAX
pool does: the pipelined harvest, the refills and the provably-done skip
follow the same protocol.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ps_slm_tpu.inference.continuous as jc
import ps_slm_tpu.inference.continuous_beam as jcb
import ps_slm_tpu.inference.continuous_spec as jcs
from ps_slm_tpu.models import qwen2 as jqwen2
from ps_slm_tpu_torch import convert
from ps_slm_tpu_torch.inference import continuous, continuous_beam, continuous_spec
from ps_slm_tpu_torch.inference.generate import beam_generate, greedy_generate
from ps_slm_tpu_torch.models import qwen2

PREFILL = 8
MAX_NEW = 12
KW = dict(vocab_size=32, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, head_dim=8)


@functools.lru_cache(maxsize=None)
def _setup(n=6):
    """(JAX cfg, params, port LLM, requests {key: (embeds, mask, pos)} as
    numpy, B=1, ragged lengths 4..PREFILL)."""
    jcfg = jqwen2.Qwen2Config.tiny(**KW)
    params = jqwen2.init_params(jax.random.PRNGKey(0), jcfg)
    llm = qwen2.Qwen2Model(qwen2.Qwen2Config.tiny(**KW))
    llm.load_state_dict(convert.qwen2_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(3)
    reqs = {}
    for i in range(n):
        s = int(rng.integers(4, PREFILL + 1))
        ids = rng.integers(0, 32, size=(1, s))
        emb = np.array(jqwen2.embed(params, jnp.asarray(ids)))
        reqs[f"utt{i}"] = (emb, np.ones((1, s), bool), np.arange(s)[None])
    return jcfg, params, llm.eval(), reqs


def _port_merged(req):
    emb, mask, pos = req
    return SimpleNamespace(embeds=torch.from_numpy(emb), attention_mask=torch.from_numpy(mask),
                           position_ids=torch.from_numpy(pos))


def _jax_merged(req):
    emb, mask, pos = req
    return SimpleNamespace(embeds=jnp.asarray(emb), attention_mask=jnp.asarray(mask),
                           position_ids=jnp.asarray(pos))


def _static(llm, reqs, *, eos, beams=1, kv_bits=16, length_penalty=1.0):
    """The port's static decoder on each request's left-padded prefill,
    EOS left out (greedy: cut at the first EOS)."""
    out = {}
    for key, req in reqs.items():
        args = continuous._left_pad_merged(_port_merged(req), PREFILL)
        if beams == 1:
            toks = greedy_generate(llm, *args, max_new_tokens=MAX_NEW, eos_token_id=eos,
                                   kv_bits=kv_bits)[0].numpy()
            cut = np.where(toks == eos)[0]
            out[key] = toks[:cut[0]] if len(cut) else toks
        else:
            toks = beam_generate(llm, *args, max_new_tokens=MAX_NEW, eos_token_id=eos,
                                 num_beams=beams, length_penalty=length_penalty,
                                 kv_bits=kv_bits)[0].numpy()
            out[key] = toks[toks != eos]
    return out


def _payload(kind, key, drafts):
    return ({"key": key}, list(drafts[key]), len(drafts[key])) if kind == "spec" else {"key": key}


def _pools(kind, monkeypatch, *, num_slots=2, **kw):
    """The JAX and the port pool of ``kind`` with the same knobs, each
    counting its chunk launches (``calls``)."""
    jcfg, params, llm, reqs = _setup()
    jcls, jmod, jfn, pcls = {
        "greedy": (jc.ContinuousGreedyDecoder, jc, "_pool_steps",
                   continuous.ContinuousGreedyDecoder),
        "spec": (jcs.ContinuousSpeculativeDecoder, jcs, "_pool_spec_steps",
                 continuous_spec.ContinuousSpeculativeDecoder),
        "beam": (jcb.ContinuousBeamDecoder, jcb, "_pool_steps",
                 continuous_beam.ContinuousBeamDecoder),
    }[kind]
    calls = {"jax": 0, "port": 0}
    orig_j, orig_p = getattr(jmod, jfn), pcls._launch_chunk

    def count_j(*a, **k):
        calls["jax"] += 1
        return orig_j(*a, **k)

    def count_p(self):
        calls["port"] += 1
        return orig_p(self)

    monkeypatch.setattr(jmod, jfn, count_j)
    monkeypatch.setattr(pcls, "_launch_chunk", count_p)
    jmodel = SimpleNamespace(llm_cfg=jcfg)
    jmodel._merged_jit = lambda p, batch: _jax_merged(reqs[batch["key"]])
    common = dict(num_slots=num_slots, prefill_len=PREFILL, max_new_tokens=MAX_NEW, **kw)
    jdec = jcls(jmodel, {"llm": params}, **common)
    pdec = pcls(SimpleNamespace(llm=llm), merge=lambda batch: _port_merged(reqs[batch["key"]]),
                device="cpu", **common)
    return jdec, pdec, calls


def _both(kind, monkeypatch, requests, stop_after=None, **kw):
    jdec, pdec, calls = _pools(kind, monkeypatch, **kw)
    want = dict(jdec.run(requests(), stop_after=stop_after))
    got_list = list(pdec.run(requests(), stop_after=stop_after))
    got = dict(got_list)
    assert len(got_list) == len(got) == len(want), "each request answered once"
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert calls["port"] == calls["jax"] > 0, calls
    return got, calls


def _eos(llm, reqs):
    """A token greedy decoding emits mid-way in one request, so requests
    end at different steps (some at MAX_NEW)."""
    toks = _static(llm, reqs, eos=31)
    return int(toks["utt0"][4])


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_greedy_pool_equals_jax_pool_and_static(kv_bits, monkeypatch):
    _, _, llm, reqs = _setup()
    eos = _eos(llm, reqs)
    got, _ = _both("greedy", monkeypatch, lambda: ((k, {"key": k}) for k in reqs),
                   eos_token_id=eos, sync_every=3, kv_bits=kv_bits)
    want = _static(llm, reqs, eos=eos, kv_bits=kv_bits)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert {len(v) for v in want.values()} >= {MAX_NEW} and min(map(len, want.values())) < MAX_NEW


def test_greedy_pool_stop_after_and_a_live_source(monkeypatch):
    """Per-request caps free slots early; a source that yields ``None``
    (nothing ready) keeps the in-flight slots stepping."""
    _, _, llm, reqs = _setup()
    eos = _eos(llm, reqs)
    caps = {k: c for k, c in zip(reqs, (2, 5, 1, 3, 12, 7))}
    keys = list(reqs)

    def live():
        yield keys[0], {"key": keys[0]}
        for _ in range(3):
            yield None
        for k in keys[1:]:
            yield k, {"key": k}

    got, _ = _both("greedy", monkeypatch, live, stop_after=caps, eos_token_id=eos,
                   sync_every=4)
    want = _static(llm, reqs, eos=eos)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key][:caps[key]], err_msg=key)
        assert len(got[key]) <= caps[key]


@pytest.mark.parametrize("kind", ["greedy", "spec", "beam"])
def test_pools_reach_max_new_in_every_slot(kind, monkeypatch):
    """An EOS no request emits: every slot decodes to MAX_NEW, writing the
    last cells of its cache row (and the speculative pool's window past
    them), and the provably-done skip drops the terminal chunk."""
    _, _, llm, reqs = _setup()
    eos = 32                                  # outside the vocabulary
    drafts = _static(llm, reqs, eos=eos)
    assert all(len(v) == MAX_NEW for v in drafts.values())
    kw = dict(eos_token_id=eos, sync_every=4, kv_bits=8 if kind == "spec" else 16)
    if kind == "spec":
        kw.update(window=4, draft_max=16)
    if kind == "beam":
        kw.update(num_beams=3)
    got, calls = _both(kind, monkeypatch,
                       lambda: ((k, _payload(kind, k, drafts)) for k in reqs), **kw)
    want = _static(llm, reqs, eos=eos, beams=3 if kind == "beam" else 1, kv_bits=kw["kv_bits"])
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert len(got[key]) == MAX_NEW


@pytest.mark.parametrize("draft,kv_bits", [("oracle", 16), ("random", 16), ("corrupted", 8)])
def test_speculative_pool_equals_jax_pool_and_greedy(draft, kv_bits, monkeypatch):
    _, _, llm, reqs = _setup()
    eos = _eos(llm, reqs)
    want = _static(llm, reqs, eos=eos, kv_bits=kv_bits)
    rng = np.random.default_rng(7)
    if draft == "oracle":
        drafts = want
    elif draft == "random":
        drafts = {k: rng.integers(0, 32, size=int(rng.integers(0, 10))) for k in reqs}
    else:
        drafts = {k: np.where(rng.random(len(v)) < 0.3, (v + 7) % 32, v) for k, v in want.items()}
    got, calls = _both("spec", monkeypatch,
                       lambda: ((k, _payload("spec", k, drafts)) for k in reqs),
                       eos_token_id=eos, window=4, draft_max=16, sync_every=2,
                       kv_bits=kv_bits)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if draft == "oracle":
        assert calls["port"] * 2 < sum(map(len, want.values())), calls


@pytest.mark.parametrize("length_penalty,kv_bits", [(1.0, 16), (0.6, 8), (-0.5, 16)])
def test_beam_pool_equals_jax_pool_and_static_beam(length_penalty, kv_bits, monkeypatch):
    _, _, llm, reqs = _setup()
    eos = _eos(llm, reqs)
    got, _ = _both("beam", monkeypatch, lambda: ((k, {"key": k}) for k in reqs),
                   eos_token_id=eos, num_beams=3, length_penalty=length_penalty,
                   sync_every=3, kv_bits=kv_bits)
    want = _static(llm, reqs, eos=eos, beams=3, kv_bits=kv_bits, length_penalty=length_penalty)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("kind", ["greedy", "spec", "beam"])
def test_pools_refuse_a_prefill_longer_than_the_bucket(kind):
    _, _, llm, reqs = _setup()
    key = max(reqs, key=lambda k: reqs[k][0].shape[1])
    cls = {"greedy": continuous.ContinuousGreedyDecoder,
           "spec": continuous_spec.ContinuousSpeculativeDecoder,
           "beam": continuous_beam.ContinuousBeamDecoder}[kind]
    dec = cls(SimpleNamespace(llm=llm), merge=lambda batch: _port_merged(reqs[batch["key"]]),
              num_slots=1, prefill_len=reqs[key][0].shape[1] - 1, max_new_tokens=4,
              eos_token_id=0, device="cpu")
    with pytest.raises(ValueError, match="exceeds pool prefill bucket"):
        list(dec.run([(key, _payload(kind, key, {key: [1, 2]}))]))
    if kind == "beam":
        with pytest.raises(ValueError, match="stop_after"):
            list(dec.run([], stop_after={key: 1}))


def _pool_ptrs(pool) -> dict:
    """Each pool tensor's storage, the cache's leaves by layer."""
    out = {}
    for name, v in vars(pool).items():
        if name == "cache":
            out.update({f"cache.{i}.{j}": t.data_ptr()
                        for i, layer in enumerate(v) for j, t in enumerate(layer)})
        else:
            out[name] = v.data_ptr()
    return out


def test_greedy_pool_writes_its_tensors_in_place():
    """The precondition of the chunk's CUDA graph: across a run with refills
    between chunks every pool tensor keeps its storage.  On the CPU no
    graph is built: the chunks run eagerly and count no capture or
    replay, while ``pool.chunks`` counts them."""
    from ps_slm_tpu_torch.utils import profiler

    _, _, llm, reqs = _setup()
    eos = _eos(llm, reqs)
    dec = continuous.ContinuousGreedyDecoder(
        SimpleNamespace(llm=llm), merge=lambda batch: _port_merged(reqs[batch["key"]]),
        num_slots=2, prefill_len=PREFILL, max_new_tokens=MAX_NEW, eos_token_id=eos,
        sync_every=3, device="cpu")
    assert dec.graph is None
    want = _pool_ptrs(dec.pool)
    events = []
    launch, insert = dec._launch_chunk, dec._insert_chunk

    def launch_chunk():
        copy = launch()
        events.append(("chunk", _pool_ptrs(dec.pool)))
        return copy

    def insert_chunk(*a, **k):
        insert(*a, **k)
        events.append(("refill", _pool_ptrs(dec.pool)))

    dec._launch_chunk, dec._insert_chunk = launch_chunk, insert_chunk
    before = profiler.counts()
    got = dict(dec.run((k, {"key": k}) for k in reqs))
    change = {k: v - before.get(k, 0) for k, v in profiler.counts().items()}
    assert set(got) == set(reqs)
    kinds = [kind for kind, _ in events]
    assert "refill" in kinds[kinds.index("chunk"):], "a refill between chunks"
    for kind, ptrs in events:
        assert ptrs == want, kind
    assert change["pool.chunks"] == kinds.count("chunk") > 0
    assert change.get("pool.graph_replays", 0) == change.get("pool.graph_captures", 0) == 0


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_a_chunk_on_the_idle_pool_changes_only_cache_cell_0(kv_bits):
    """What the capture runs on a CUDA device before the first request: a
    chunk over an idle pool leaves every mask, offset, position, count and
    token as ``_init_pool`` made them, and of the cache writes only each
    slot's cell 0 (a refill's ``install_rows`` overwrites the whole row)."""
    _, _, llm, reqs = _setup()
    dec = continuous.ContinuousGreedyDecoder(
        SimpleNamespace(llm=llm), merge=lambda batch: _port_merged(reqs[batch["key"]]),
        num_slots=3, prefill_len=PREFILL, max_new_tokens=MAX_NEW, eos_token_id=5,
        sync_every=4, kv_bits=kv_bits, device="cpu")
    with torch.inference_mode():
        dec._steps()
    fresh = continuous._init_pool(llm, 3, PREFILL + MAX_NEW, 4, 5, dec.dtype, kv_bits,
                                  dec.dev)
    for name, v in vars(fresh).items():
        if name != "cache":
            assert torch.equal(getattr(dec.pool, name), v), name
    for layer, layer0 in zip(dec.pool.cache, fresh.cache):
        for leaf, leaf0 in zip(layer, layer0):
            assert torch.equal(leaf[:, 1:], leaf0[:, 1:])
            assert leaf[:, 0].abs().sum() > 0
