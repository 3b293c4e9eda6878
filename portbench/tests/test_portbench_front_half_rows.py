"""The reader of ``pool.front_half_rows.decode``: the requests a front-half
call of the slot pool's refills, from the program's counters in the
traced window; nothing when the window recorded no call, and nothing from
a program whose profiler has no ``pool.front_half_calls`` counter (a pool
that runs the front half once a same-shape group)."""

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
    return harness.load_metric("pool.front_half_rows.decode").read(run)


@pytest.mark.parametrize("calls,rows,value", [(2, 10, 5.0), (3, 16, 16 / 3), (7, 7, 1.0)])
def test_front_half_rows_reads_the_programs_counters(calls, rows, value, monkeypatch):
    record = {"spans": {}, "counts": dict(COUNTS, **{"pool.front_half_calls": calls,
                                                     "pool.front_half_rows": rows})}
    monkeypatch.setattr(program_spans, "recorded", lambda: record)
    assert _reading(_run()) == pytest.approx(value)


@pytest.mark.parametrize("record", [{"spans": {}, "counts": {}}, None])
def test_front_half_rows_is_none_when_nothing_was_recorded(record, monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", lambda: record)
    assert _reading(_run()) is None


def test_front_half_rows_reads_nothing_from_a_program_without_the_counter(monkeypatch):
    """The parent of this reader: refills counted, no front-half counter."""
    stub = types.ModuleType("ps_slm_tpu_torch.utils.profiler")
    stub.COUNTERS = frozenset({"pool.requests"})
    stub.recorded = lambda: {"spans": {}, "counts": dict(COUNTS)}
    monkeypatch.setitem(sys.modules, "ps_slm_tpu_torch.utils.profiler", stub)
    import ps_slm_tpu_torch.utils as utils
    monkeypatch.setattr(utils, "profiler", stub, raising=False)
    assert _reading(_run()) is None
