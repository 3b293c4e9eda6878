"""The reader of ``pool.graph_share.decode``: the share of the slot pool's
chunks replayed from its CUDA graph, from the program's counters in the
traced window; nothing when the window recorded no chunk, and nothing from
a program whose profiler has no ``pool.graph_replays`` counter (a pool that
never captures its chunk)."""

import sys
import types

import pytest

from portbench import harness, program_spans

COUNTS = {"pool.requests": 10, "pool.chunks": 50, "pool.slot_steps": 50 * 32 * 8,
          "pool.tokens": 3200, "pool.slot_s": 640.0}


def _run():
    return harness.Run(cell={}, cfg={}, mix={}, seed=0, seconds=1, trace=True, device="cpu",
                       t0=0.0, workdir="")


def _reading(run):
    return harness.load_metric("pool.graph_share.decode").read(run)


@pytest.mark.parametrize("replays,value", [(50, 100.0), (40, 80.0), (0, 0.0)])
def test_graph_share_reads_the_programs_counters(replays, value, monkeypatch):
    record = {"spans": {}, "counts": dict(COUNTS, **{"pool.graph_replays": replays})}
    monkeypatch.setattr(program_spans, "recorded", lambda: record)
    assert _reading(_run()) == pytest.approx(value)


@pytest.mark.parametrize("record", [{"spans": {}, "counts": {}}, None])
def test_graph_share_is_none_when_nothing_was_recorded(record, monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", lambda: record)
    assert _reading(_run()) is None


def test_graph_share_reads_nothing_from_a_program_without_the_counter(monkeypatch):
    """The parent of this reader: chunks counted, no replay counter."""
    stub = types.ModuleType("ps_slm_tpu_torch.utils.profiler")
    stub.COUNTERS = frozenset({"pool.chunks"})
    stub.recorded = lambda: {"spans": {}, "counts": dict(COUNTS)}
    monkeypatch.setitem(sys.modules, "ps_slm_tpu_torch.utils.profiler", stub)
    import ps_slm_tpu_torch.utils as utils
    monkeypatch.setattr(utils, "profiler", stub, raising=False)
    assert _reading(_run()) is None
