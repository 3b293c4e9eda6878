"""PyTorch port: the streaming server (``cli/serve.py``), static batching
(``inference/static_serve.py``) and ``serve_route=auto``
(``inference/routing.py``) against the JAX package's (CPU, fp32).

* The router: fake decoders and one injected clock drive both packages'
  ``route_serve``; decisions, logs and outputs must be the same.
* ``StaticBatchDecoder._stack``: the padded arrays equal JAX's.
* The serve CLI on ``tests/test_cli.py``'s tiny fixtures (random init from
  the JAX config's seed, handed to the port as a full reference checkpoint;
  fp32): 4 utterances plus a malformed line and an
  unreadable path, through the pool, static batches, streamed partials
  and the beam pool; each JSONL equals the JAX CLI's (as a set of lines:
  the order is completion order, which depends on when the reader thread
  delivers lines).  One module-scoped JAX run a mode.  Waveforms go on the
  wire as float32 there: the JAX static stacking casts int16 PCM to
  float32 without its rescale (the port keeps int16, checked against the
  port's pool).

About 35 s on one CPU, most of it the JAX CLI's compiles.
"""

import io
import json
import logging

import jax
import numpy as np
import pytest
import torch

from ps_slm_tpu.cli import serve as jserve
from ps_slm_tpu.config import RunConfig as JaxRunConfig
from ps_slm_tpu.config import parse_cli as jax_parse_cli
from ps_slm_tpu.data import audio_io as jaudio
from ps_slm_tpu.inference import routing as jrouting
from ps_slm_tpu.inference.static_serve import StaticBatchDecoder as JaxStatic
from ps_slm_tpu.models.tasu import model_factory as jax_model_factory
from ps_slm_tpu.training.checkpoint import export_reference_checkpoint as jax_export
from ps_slm_tpu_torch.cli import serve
from ps_slm_tpu_torch.inference import routing
from ps_slm_tpu_torch.inference.static_serve import StaticBatchDecoder


# ----------------------------------------------------------------------------
# the router, under one injected clock
# ----------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


class _Decoder:
    """Serves each request in ``per_req_s`` of the injected clock; the
    completion length is the request's payload."""

    def __init__(self, name, served, clock, per_req_s):
        self.name, self.served, self.clock, self.per_req_s = name, served, clock, per_req_s

    def run(self, batches, on_partial=None):
        for item in batches:
            if item is None:
                continue
            key, length = item
            self.clock.t += self.per_req_s
            self.served.append((self.name, key))
            yield key, np.zeros(length, np.int32)


def _route(module, monkeypatch, lengths, pool_s, static_s, **kw):
    clock = _Clock()
    monkeypatch.setattr(module, "time", clock)
    served, logs, built = [], [], []

    def make(name, per):
        def f():
            built.append(name)
            return _Decoder(name, served, clock, per)
        return f

    reqs = [None if ln is None else (f"r{i}", ln) for i, ln in enumerate(lengths)]
    out = [(k, len(t)) for k, t in module.route_serve(
        iter(reqs), make("pool", pool_s), make("static", static_s), log=logs.append, **kw)]
    return out, served, logs, built


@pytest.mark.parametrize("case", [
    # short answers, static measured faster: explore static, stay there
    dict(lengths=[4] * 24, pool_s=0.04, static_s=0.015),
    # short answers, the pool measured faster: back to the pool
    dict(lengths=[4] * 24, pool_s=0.015, static_s=0.04),
    # drift from short to long and back; None items from a live source
    dict(lengths=[4, None] * 6 + [100] * 12 + [4] * 10, pool_s=0.02, static_s=0.02),
    # segments too short to measure: the length prior alone decides
    dict(lengths=[100] * 8 + [4] * 8, pool_s=0.001, static_s=0.001),
])
def test_route_serve_decides_as_jax(monkeypatch, case):
    kw = dict(probe=4, static_below=16)
    want = _route(jrouting, monkeypatch, case["lengths"], case["pool_s"], case["static_s"], **kw)
    got = _route(routing, monkeypatch, case["lengths"], case["pool_s"], case["static_s"], **kw)
    assert got == want
    out, served, logs, built = got
    assert [k for k, _ in out] == [f"r{i}" for i, ln in enumerate(case["lengths"]) if ln]
    assert len(built) == len(set(built))            # each decoder built once
    assert {r for r, _ in served} >= {"pool"}


# ----------------------------------------------------------------------------
# StaticBatchDecoder
# ----------------------------------------------------------------------------

def _tc(batch_size):
    from types import SimpleNamespace

    return SimpleNamespace(decode_slots=batch_size, num_beams=1, max_new_tokens=8,
                           do_sample=False, min_length=1, top_p=1.0, temperature=1.0,
                           length_penalty=1.0, repetition_penalty=1.0, kv_cache_bits=16)


def _payloads(kind, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i, (s, a) in enumerate([(3, 10), (7, 20), (5, 33)]):
        g = {"input_ids": rng.integers(1, 99, size=(1, s)).astype(np.int32),
             "attention_mask": np.ones((1, s), bool)}
        if kind == "features":
            g["input_features"] = rng.normal(size=(1, a, 4)).astype(np.float32)
            g["input_feature_length"] = np.array([a - i], np.int32)
        else:
            g["waveform"] = rng.normal(size=(1, 1000 * a)).astype(np.float32)
            g["waveform_length"] = np.array([1000 * a - 7 * i], np.int32)
        out.append((f"k{i}", g))
    return out


@pytest.mark.parametrize("kind", ["features", "waveform"])
def test_stack_equals_jax(kind):
    from types import SimpleNamespace

    dc = SimpleNamespace(token_bucket=8, feature_bucket=16)
    jmodel = SimpleNamespace(pad_token_id=7,
                             params={"llm": {"embed_tokens": np.zeros((2, 2), np.float32)}})
    want, wn = JaxStatic(jmodel, _tc(5), dc, eos_token_id=2)._stack(_payloads(kind))
    pmodel = SimpleNamespace(pad_token_id=7, llm=torch.nn.Module())
    pmodel.llm.embed_tokens = torch.nn.Embedding(2, 2)
    dec = StaticBatchDecoder(pmodel, _tc(5), dc, eos_token_id=2, device="cpu")
    got, n = dec._stack([(k, {n: torch.from_numpy(v) for n, v in g.items()})
                         for k, g in _payloads(kind)])
    assert n == wn == 3 and sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)


def test_static_run_groups_flushes_and_refuses_pool_options():
    dec = StaticBatchDecoder(None, _tc(3), None, eos_token_id=2, device="cpu")
    calls = []

    def fake(group):
        calls.append([k for k, _ in group])
        for k, _ in group:
            yield k, np.asarray([1], np.int32)

    dec._decode_group = fake
    items = [("a", {}), ("b", {}), None, ("c", {}), ("d", {}), ("e", {}), ("f", {})]
    assert [k for k, _ in dec.run(iter(items))] == list("abcdef")
    assert calls == [["a", "b"], ["c", "d", "e"], ["f"]]
    with pytest.raises(ValueError, match="stop_after"):
        list(dec.run(iter(items), stop_after={"a": 1}))
    with pytest.raises(ValueError, match="on_partial"):
        list(dec.run(iter(items), on_partial=print))


def test_mixed_payload_group_partitioned():
    dec = StaticBatchDecoder(None, _tc(4), None, eos_token_id=2, device="cpu")
    seen = []

    def uniform(group):
        kinds = {StaticBatchDecoder._payload_kind(g) for _, g in group}
        seen.append((sorted(k for k, _ in group), kinds.pop()))
        for k, _ in group:
            yield k, np.asarray([1], np.int32)

    dec._decode_uniform = uniform
    group = [("f1", {"input_features": 0}), ("w1", {"waveform": 0}), ("f2", {"input_features": 0})]
    assert sorted(k for k, _ in dec._decode_group(group)) == ["f1", "f2", "w1"]
    assert seen == [(["f1", "f2"], "input_features"), (["w1"], "waveform")]


# ----------------------------------------------------------------------------
# the serve CLI against the JAX CLI
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """tests/test_cli.py's utterances (4 of 0.5-1 s in a wav.ark), and a
    requests file with a malformed line and an unreadable path."""
    d = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(0)
    entries = {f"utt{i}": (16000, rng.normal(size=int(rng.integers(8000, 16000))).astype(
        np.float32) * 0.1) for i in range(4)}
    offsets = jaudio.write_kaldi_wav_ark(str(d / "wav.ark"), entries)
    lines = [json.dumps({"key": k, "path": f"{d / 'wav.ark'}:{off}"}) for k, off in offsets.items()]
    lines.insert(2, "{not json at all")
    lines.insert(4, json.dumps({"key": "missing", "path": str(d / "nope.wav")}))
    (d / "requests.jsonl").write_text("\n".join(lines) + "\n")
    (d / "multiprompt.jsonl").write_text(json.dumps({"task": "ASR", "prompt": "transcribe:"}) + "\n")
    # the JAX CLI's random init, handed to the port as a full checkpoint
    cfg = jax_parse_cli(_args(d)[:-1], JaxRunConfig())
    jax_export(jax_model_factory(cfg.train_config, cfg.model_config,
                                 rng=jax.random.PRNGKey(cfg.train_config.seed)), str(d / "init.bin"))
    return d


def _port(d, *extra):
    return _args(d, f"ckpt_path={d / 'init.bin'}", *extra)


def _args(d, *extra):
    return [
        "++model_config.llm_path=",
        "++model_config.encoder_dim=11",
        "++model_config.llm_dim=64",
        '++model_config.encoder_config_overrides={"input_size": 560}',
        "++train_config.ctc_posterior=true",
        "++train_config.do_psd=true",
        "++train_config.mixed_precision=false",
        "++train_config.num_beams=1",
        "++train_config.max_new_tokens=6",
        "++train_config.decode_slots=2",
        "++train_config.decode_sync_every=3",
        f"++dataset_config.multitask_prompt_path={d}/multiprompt.jsonl",
        "++dataset_config.eval_max_frame_length=64",
        "++dataset_config.feature_bucket=16",
        "++dataset_config.token_bucket=8",
        "++dataset_config.waveform_dtype=float32",
        f"++log_config.log_file={d}/log.txt",
        *extra,
        str(d / "requests.jsonl"),
    ]


MODES = {
    "pool": ["++train_config.serve_route=pool"],
    "static": ["++train_config.serve_route=static"],
    "stream_partials": ["++train_config.stream_partials=true"],
    "beam": ["++train_config.serve_route=pool", "++train_config.num_beams=4"],
}


def _serve(main, args, **kw):
    out = io.StringIO()
    assert main(args, stdout=out, **kw) == 0
    return [json.loads(line) for line in out.getvalue().splitlines()]


@pytest.fixture(scope="module")
def jax_runs(fixtures):
    return {mode: _serve(jserve.main, _args(fixtures, *extra)) for mode, extra in MODES.items()}


def _as_set(lines):
    return sorted(json.dumps(r, sort_keys=True) for r in lines)


@pytest.mark.parametrize("mode", list(MODES))
def test_serve_cli_jsonl_equals_jax(fixtures, jax_runs, mode):
    got = _serve(serve.main, _port(fixtures, *MODES[mode]), device="cpu")
    want = jax_runs[mode]
    finals = [r for r in got if "text" in r and not r.get("partial")]
    assert sorted(r["key"] for r in finals) == [f"utt{i}" for i in range(4)]
    errors = sorted(r["key"] for r in got if "error" in r)
    assert errors == ["<line 3>", "missing"]
    if mode != "stream_partials":
        assert _as_set(got) == _as_set(want)
        return
    # partials: the harvests' timing varies, so hold the finals exactly
    # and each partial to a growing prefix of its key's final text
    assert _as_set(finals) == _as_set([r for r in want if "text" in r and not r.get("partial")])
    text = {r["key"]: r["text"] for r in finals}
    partials = [r for r in got if r.get("partial")]
    assert partials
    last = {}
    for r in partials:
        assert text[r["key"]].startswith(r["text"])
        assert r["text"].startswith(last.get(r["key"], ""))
        last[r["key"]] = r["text"]


def test_static_route_keeps_int16_pcm(fixtures, jax_runs):
    """On the default int16 wire the port's static batches decode what its
    pool decodes (the waveform keeps its dtype, so the front end rescales
    it)."""
    int16 = [a for a in _port(fixtures) if "waveform_dtype" not in a]
    pool = _serve(serve.main, int16 + ["++train_config.serve_route=pool"], device="cpu")
    static = _serve(serve.main, int16 + ["++train_config.serve_route=static"], device="cpu")
    assert _as_set(static) == _as_set(pool) == _as_set(jax_runs["pool"])


def test_serve_cli_auto_routes_to_static(fixtures, caplog):
    with caplog.at_level(logging.INFO, logger="serve"):
        got = _serve(serve.main, _port(fixtures, "++train_config.route_probe=2",
                                       "++train_config.route_static_below=100"), device="cpu")
    keys = [r["key"] for r in got if "text" in r]
    assert sorted(keys) == [f"utt{i}" for i in range(4)]
    assert any("routing to static batching" in r.message for r in caplog.records)


def test_serve_cli_refuses_what_the_route_ignores(fixtures):
    with pytest.raises(ValueError, match="serve_route"):
        serve.main(_args(fixtures, "++train_config.serve_route=fast"), device="cpu")
    with pytest.raises(ValueError, match="repetition_penalty"):
        serve.main(_args(fixtures, "++train_config.repetition_penalty=1.2"), device="cpu")
    with pytest.raises(ValueError, match="multiple request files"):
        serve.main(_args(fixtures) + [str(fixtures / "multiprompt.jsonl")], device="cpu")


def test_serve_entry_points_default_to_cuda_and_raise_without_it(fixtures):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    import inspect

    assert inspect.signature(serve.main).parameters["device"].default == "cuda"
    assert inspect.signature(StaticBatchDecoder).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(_args(fixtures), stdout=io.StringIO())
    with pytest.raises(RuntimeError, match="cuda"):
        StaticBatchDecoder(None, _tc(2), None, eos_token_id=2)
