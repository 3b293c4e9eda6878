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


SPEECH = 250


@functools.lru_cache(maxsize=None)
def _tasu(waveform: bool):
    """A tiny audio-TASU model (CTC posterior, PSD, linear-silu) built by the
    JAX factory and converted into the port's, as ``test_torch_generate``
    builds it; 560 features (80 mel x 7 LFR) for the waveform front end."""
    from ps_slm_tpu.config import ModelConfig as JaxModelConfig
    from ps_slm_tpu.config import TrainConfig as JaxTrainConfig
    from ps_slm_tpu.models import tasu as jtasu
    from ps_slm_tpu_torch.config import ModelConfig, TrainConfig
    from ps_slm_tpu_torch.models import tasu

    flags = dict(ctc_posterior=True, do_psd=True)
    over = {"input_size": 560} if waveform else None
    jm = jtasu.model_factory(
        JaxTrainConfig(**flags),
        JaxModelConfig(llm_path="", encoder_dim=11, llm_dim=64, encoder_config_overrides=over),
        rng=jax.random.PRNGKey(0))
    pm = tasu.model_factory(TrainConfig(**flags),
                            ModelConfig(encoder_dim=11, llm_dim=64, encoder_config_overrides=over),
                            device="cpu")
    pm.load_state_dict(convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params)))
    pm.speech_token_id, pm.pad_token_id = SPEECH, 7
    return pm.eval()


def _audio_requests(waveform: bool, n: int = 7) -> list:
    """``n`` B=1 batches as the collator gives them: prompts of 5 and 9
    tokens, audio of three lengths, each padded to its own bucket."""
    rng = np.random.default_rng(5)
    out = []
    for i in range(n):
        s = (5, 9)[i % 2]
        ids = rng.integers(1, 200, size=(1, s))
        ids[0, 2] = SPEECH
        batch = {"input_ids": torch.from_numpy(ids), "attention_mask": torch.ones(1, s, dtype=bool)}
        if waveform:
            valid, width = ((16000, 19200), (24000, 28800), (40000, 48000))[i % 3]
            wav = np.zeros((1, width), np.float32)
            wav[0, :valid] = 0.1 * rng.normal(size=valid)
            batch.update(waveform=torch.from_numpy(wav),
                         waveform_length=torch.tensor([valid], dtype=torch.int32))
        else:
            valid, width = ((8, 12), (13, 16), (20, 24))[i % 3]
            feats = np.zeros((1, width, 24), np.float32)
            feats[0, :valid] = rng.normal(size=(valid, 24))
            batch.update(input_features=torch.from_numpy(feats),
                         input_feature_length=torch.tensor([valid], dtype=torch.int32))
        batch["audio_seconds"] = torch.tensor([valid / 16000.0])
        out.append((f"utt{i}", batch))
    return out


@pytest.mark.parametrize("kind", ["features", "waveform", "stub"])
def test_a_refill_runs_the_front_half_once_over_its_padded_requests(kind):
    """A refill of requests of three audio lengths and two prompt widths
    pads them by the collator's rule and runs the front half once: each
    row's merged prefill equals its own B=1 ``prepare_merged`` at the
    valid positions (masks exact, positions exact where valid), and the
    pool's tokens equal greedy ``generate``'s per request.  Payloads
    without shapes (the stub merge) still run one call each."""
    from ps_slm_tpu_torch.inference.generate import generate
    from ps_slm_tpu_torch.utils import profiler

    if kind == "stub":
        _, _, llm, reqs = _setup()
        model, eos = SimpleNamespace(llm=llm), _eos(llm, reqs)
        requests = [(k, {"key": k}) for k in reqs]
        merge = lambda batch: _port_merged(reqs[batch["key"]])     # noqa: E731
        prefill = PREFILL
    else:
        model, merge, eos = _tasu(kind == "waveform"), None, 3
        requests, prefill = _audio_requests(kind == "waveform"), 64
    dec = continuous.ContinuousGreedyDecoder(
        model, merge=merge, num_slots=len(requests), prefill_len=prefill,
        max_new_tokens=MAX_NEW, eos_token_id=eos, sync_every=3, device="cpu")
    rows = {}
    insert = dec._insert_chunk

    def insert_chunk(slots, embeds, mask, pos, **kw):
        insert(slots, embeds, mask, pos, **kw)
        rows.update({s: (embeds[i], mask[i], pos[i]) for i, s in enumerate(slots.tolist())})

    dec._insert_chunk = insert_chunk
    slot_of = {key: len(requests) - 1 - i for i, (key, _) in enumerate(requests)}
    before = profiler.counts()
    got = dict(dec.run(iter(requests)))
    change = {k: v - before.get(k, 0) for k, v in profiler.counts().items()}
    n = len(requests)
    calls = n if kind == "stub" else 1
    assert (change["pool.front_half_calls"], change["pool.front_half_rows"]) == (calls, n)
    if kind == "stub":
        return
    merge = continuous.default_merge(model)
    for key, batch in requests:
        embeds, mask, pos = rows[slot_of[key]]
        want = continuous._left_pad_merged(merge(batch), prefill)
        assert torch.equal(mask, want[1][0]), key
        valid = mask.bool()
        assert torch.equal(pos[valid], want[2][0][valid]), key
        torch.testing.assert_close(embeds[valid], want[0][0][valid], rtol=0, atol=1e-6)
        toks = generate(model, batch, eos_token_id=eos, num_beams=1, max_new_tokens=MAX_NEW,
                        device="cpu")[0].numpy()
        cut = np.where(toks == eos)[0]
        np.testing.assert_array_equal(got[key], toks[:cut[0]] if len(cut) else toks, err_msg=key)


def _row(frames: int, prompt: int = 5, extra: int = 1) -> dict:
    return {"input_ids": torch.zeros(1, prompt, dtype=torch.long),
            "attention_mask": torch.ones(1, prompt, dtype=torch.bool),
            "input_features": torch.zeros(1, frames, 2),
            "input_feature_length": torch.tensor([frames]), "other": torch.zeros(1, extra)}


@pytest.mark.parametrize("rows,width,want", [
    # padded by the rule: by frames, as many a call as the budget holds
    ([_row(30), _row(10, 9), _row(20), _row(10)], 1, [[1, 3, 2, 0]]),
    ([_row(30), _row(10, 9), _row(20), _row(10)], continuous.FRONT_HALF_BYTES // (4 * 40),
     [[1, 3], [2], [0]]),
    # 64 rows of 30.72 s at SenseVoiceSmall's posterior: 20 a call
    ([_row(516)] * 64, 25055, [list(range(i, min(i + 20, 64))) for i in range(0, 64, 20)]),
    # a key outside the rule whose shapes differ: same-shape groups in
    # power-of-two chunks
    ([_row(10, extra=2), _row(10), _row(10), _row(10), _row(20)], 1, [[0], [1, 2], [3], [4]]),
])
def test_front_half_calls_follow_the_byte_budget(rows, width, want):
    assert continuous.front_half_calls(rows, width) == want
