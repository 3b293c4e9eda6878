"""PyTorch port: the tracing facility (``utils/profiler.py``) and its
spans and counters in the slot pools, the training step, the prefetcher
and the training loop's rates.

A span is a ``tasu.*`` range in a running profiler's trace and nothing
without one; the pools' counters add up to what the pool served; and the
pools answer in the same order with the profiler on and off, and as the
JAX package's pools do.
"""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_torch_continuous import _eos, _payload, _pools, _setup, _static
from test_torch_train import HALF_AUDIO, LLM_DIM, ENC_VOCAB, SPEECH, _batch

from ps_slm_tpu_torch.config import LogConfig, ModelConfig, TrainConfig
from ps_slm_tpu_torch.data.prefetch import device_prefetch
from ps_slm_tpu_torch.models import tasu
from ps_slm_tpu_torch.training import loop
from ps_slm_tpu_torch.training.step import make_train_step
from ps_slm_tpu_torch.utils import profiler

CPU = [torch.profiler.ProfilerActivity.CPU]


def _tasu_names(prof):
    """The ``tasu.*`` host events of a profile, by start."""
    evs = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("tasu.")]
    return [e.name() for e in sorted(evs, key=lambda e: e.start_ns())]


def _change(after, before):
    """The spans' calls and the counters added between two ``recorded()``."""
    spans = {p: v["calls"] - before["spans"].get(p, {"calls": 0})["calls"]
             for p, v in after["spans"].items()}
    cnts = {k: v - before["counts"].get(k, 0) for k, v in after["counts"].items()}
    return ({p: n for p, n in spans.items() if n},
            {k: v for k, v in cnts.items() if v})


def test_span_without_a_profiler_is_the_shared_noop():
    before = profiler.recorded()
    assert not torch.autograd._profiler_enabled()
    s = profiler.span("pool.launch")
    assert s is profiler.span("step") is profiler._OFF
    with s:
        torch.ones(2) + 1
    assert profiler.recorded() == before


def test_spans_nest_in_the_profilers_trace_and_their_paths():
    before = profiler.recorded()
    with torch.profiler.profile(activities=CPU) as prof:
        with profiler.span("step"):
            with profiler.span("front_half"):
                torch.ones(4) * 2
            with profiler.span("llm"):
                torch.ones(4) + 1
        with profiler.span("step"):
            pass
    assert _tasu_names(prof) == ["tasu.step", "tasu.front_half", "tasu.llm", "tasu.step"]
    spans, _ = _change(profiler.recorded(), before)
    assert spans == {"step": 2, "step/front_half": 1, "step/llm": 1}
    assert profiler.recorded()["spans"]["step"]["seconds"] > 0


def test_counters_are_named_and_always_on():
    before = profiler.counts()
    profiler.count("pool.chunks")
    profiler.count("pool.slot_s", 0.5)
    after = profiler.counts()
    assert after["pool.chunks"] - before.get("pool.chunks", 0) == 1
    assert after["pool.slot_s"] - before.get("pool.slot_s", 0) == pytest.approx(0.5)
    with pytest.raises(KeyError, match="pool.requests"):
        profiler.count("pool.request")


def test_trace_writes_counters_json_beside_the_trace(tmp_path):
    profiler.count("pool.tokens", 7)                  # before the block: not in the file
    with profiler.trace(str(tmp_path)):
        profiler.count("pool.requests", 2)
        with profiler.span("pool.admit"):
            torch.ones(3)
    data = json.loads((tmp_path / "counters.json").read_text())
    assert data["counters"] == {"pool.requests": 2}
    assert data["spans"]["pool.admit"]["calls"] == 1
    assert data["spans"]["pool.admit"]["seconds"] > 0
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert "tasu.pool.admit" in {e.get("name") for e in events}


def test_greedy_pool_counts_what_it_served(monkeypatch):
    _, _, llm, reqs = _setup()
    eos = _eos(llm, reqs)
    slots, sync = 2, 3
    _, pdec, calls = _pools("greedy", monkeypatch, num_slots=slots, eos_token_id=eos,
                            sync_every=sync)
    before, rec0 = profiler.counts(), profiler.recorded()
    with torch.profiler.profile(activities=CPU) as prof:
        got = list(pdec.run(((k, {"key": k}) for k in reqs), stop_after={"utt1": 2}))
    c = {k: v - before.get(k, 0) for k, v in profiler.counts().items()}
    assert c["pool.requests"] == len(got) == len(reqs)
    assert c["pool.tokens"] == sum(len(t) for _, t in got)
    assert c["pool.chunks"] == calls["port"] > 0
    assert c["pool.chunks"] * slots * sync == c["pool.slot_steps"]
    assert c["pool.slot_s"] > 0
    spans, cnts = _change(profiler.recorded(), rec0)
    assert cnts == {k: v for k, v in c.items() if v}          # the profiler ran throughout
    assert spans["pool.admit"] == len(reqs) + 1               # the last pull ends the source
    assert spans["pool.refill/pool.prefill"] >= 1
    assert spans["pool.launch"] == calls["port"]
    assert spans["pool.harvest"] == calls["port"]
    names = _tasu_names(prof)
    assert names[:2] == ["tasu.pool.admit", "tasu.pool.admit"] and "tasu.pool.refill" in names


@pytest.mark.parametrize("kind", ["greedy", "beam", "spec"])
def test_pools_answer_in_the_same_order_with_spans(kind, monkeypatch):
    """Each pool yields the JAX pool's ``(key, tokens)`` in the JAX pool's
    order, with the profiler off and on."""
    _, _, llm, reqs = _setup()
    eos = _eos(llm, reqs)
    drafts = _static(llm, reqs, eos=eos)
    kw = dict(eos_token_id=eos, sync_every=3)
    if kind == "spec":
        kw.update(window=4, draft_max=16, sync_every=2)
    if kind == "beam":
        kw.update(num_beams=3)
    jdec, pdec, _ = _pools(kind, monkeypatch, **kw)

    def requests():
        return ((k, _payload(kind, k, drafts)) for k in reqs)

    want = list(jdec.run(requests()))
    off = list(pdec.run(requests()))
    with torch.profiler.profile(activities=CPU):
        on = list(pdec.run(requests()))
    for got in (off, on):
        assert [k for k, _ in got] == [k for k, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_train_step_spans_each_phase():
    tc = TrainConfig(**HALF_AUDIO, lr=1e-3, warmup_steps=1)
    model = tasu.model_factory(tc, ModelConfig(encoder_dim=ENC_VOCAB, llm_dim=LLM_DIM),
                               device="cpu")
    model.speech_token_id = SPEECH
    step = make_train_step(model, tc, device="cpu")
    _, batch = _batch()
    rec0 = profiler.recorded()
    with torch.profiler.profile(activities=CPU) as prof:
        step(batch)
    spans, _ = _change(profiler.recorded(), rec0)
    assert spans == {"step": 1, "step/optimizer": 2, "step/front_half": 1, "step/llm": 1,
                     "step/loss": 1, "step/backward": 1}
    assert _tasu_names(prof) == ["tasu.step", "tasu.optimizer", "tasu.front_half", "tasu.llm",
                                 "tasu.loss", "tasu.backward", "tasu.optimizer"]


def test_prefetch_spans_the_consumers_wait():
    batches = [{"x": np.full(3, i, np.int32)} for i in range(3)]
    rec0 = profiler.recorded()
    with torch.profiler.profile(activities=CPU):
        got = [int(d["x"][0]) for _, d in device_prefetch(batches, "cpu", lambda b: b)]
    assert got == [0, 1, 2]
    spans, _ = _change(profiler.recorded(), rec0)
    assert spans == {"data.wait": 4}                # three batches and the end


def test_step_timer_counts_the_steps_of_an_interval():
    t = profiler.StepTimer(window=1)
    t.start()
    time.sleep(0.02)
    t.stop(3.0, steps=4)
    assert t.steps_per_sec == pytest.approx(4 / t.seconds)
    assert t.audio_sec_per_sec == pytest.approx(3.0 / t.seconds)
    t.start()
    t.stop(1.0)                                     # window 1: the last interval only
    assert len(t._times) == 1 and t._steps == [1]


class _SlowLoss:
    """A loss whose read waits, as a device-to-host copy waits for the
    step's kernels."""

    def __float__(self):
        time.sleep(0.02)
        return 1.0


class _QueuedStep:
    """A step that returns at once, its loss read later."""
    device, step = "cpu", 0

    def __call__(self, batch):
        return {"loss": _SlowLoss(), "acc": torch.tensor(0.5)}


def test_training_loop_logs_step_rates_not_enqueue_rates():
    state = _QueuedStep()
    logged = []
    sink = SimpleNamespace(log=lambda d, step: logged.append(d))
    batches = [{"input_feature_length": np.array([10]), "input_ids": np.zeros((1, 2))}
               for _ in range(6)]
    loop.train(None, state, TrainConfig(num_epochs=1, run_validation=False, save_last=False),
               LogConfig(log_interval=2), lambda epoch: iter(batches), logger=None,
               metric_logger=sink)
    rates = [d["train/steps_per_sec"] for d in logged]
    # each log point reads the loss three times (0.06 s) for two steps
    assert len(rates) == 3 and max(rates) < 2 / 0.06
    assert all(d["train/audio_sec_per_sec"] == pytest.approx(
        d["train/steps_per_sec"] * 10 * 0.060) for d in logged)
