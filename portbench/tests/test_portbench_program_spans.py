"""The program's spans in a traced window: the harness's reduction reads the
same busy time, idle share and rooflines with them as without them; the
breakdown names each idle gap by the innermost span, the harness's or the
program's, and puts each launch and blocking call down to the spans over
it; each reader of the program's record reads its value, and nothing from
a program that records none."""

import sys
import types

import pytest

from portbench import harness, program_spans
from portbench.tests.test_portbench_trace import EVENTS, Ev


class Annotation(Ev):
    """A span mirrored on the device's timeline, as a torch that reports
    activity types gives it."""

    def activity_type(self):
        return "gpu_user_annotation"


# the program's host spans inside the harness's train.step [0, 600), their
# device-side mirrors, and the runtime's launches and blocking calls
PROGRAM = [
    Ev("tasu.step", "CPU", 5, 590),
    Ev("tasu.front_half", "CPU", 10, 380),
    Ev("tasu.llm", "CPU", 390, 100),
    Ev("tasu.backward", "CPU", 500, 90),
    Ev("tasu.data.wait", "CPU", 650, 300),
    Annotation("tasu.step", "CUDA", 100, 400),
    Annotation("tasu.front_half", "CUDA", 100, 150),
    Ev("cudaLaunchKernel", "CPU", 20, 2),
    Ev("cudaLaunchKernel", "CPU", 30, 2),
    Ev("cudaMemcpyAsync", "CPU", 395, 2),
    Ev("cudaLaunchKernelExC", "CPU", 520, 2),         # the autograd thread's, under backward
    Ev("aten::nonzero", "CPU", 295, 50),
    Ev("aten::_local_scalar_dense", "CPU", 298, 45),
    Ev("cudaStreamSynchronize", "CPU", 300, 40),
    Ev("cudaEventSynchronize", "CPU", 700, 10),       # outside the step
    Ev("cudaLaunchKernel", "CPU", 1100, 2),           # after the window
]


def _reading(run, name):
    return harness.load_metric(name).read(run)


def test_program_spans_leave_the_device_readings_as_they_were():
    cfg = {"encoder": {"input_size": 560, "output_size": 512, "attention_heads": 4,
                       "linear_units": 2048, "num_blocks": 50, "tp_blocks": 20,
                       "kernel_size": 11, "vocab_size": 25055},
           "llm": {"hidden_size": 1536, "intermediate_size": 8960, "num_hidden_layers": 28,
                   "num_attention_heads": 12, "num_key_value_heads": 2, "head_dim": 128,
                   "vocab_size": 151936},
           "projector": {"hidden": 2048}}
    rows = [{"enc": 200, "kept": 60, "text": 90, "labels": 40}]
    readings = []
    for events in (EVENTS, EVENTS + PROGRAM):
        t = harness.summarize(events)
        run = harness.Run(cell={}, cfg=cfg, mix={}, seed=0, seconds=1, trace=True, device="cpu",
                          t0=0.0, workdir="")
        run.facts.update(steps=[{"rows": rows}], window_s=t.window_s, slots=32, weight_bits=8,
                         requests=[{"enc": 200, "kept": 60, "text": 90, "tokens": 10}])
        run.trace_summary = t
        readings.append((t.busy_s, t.window_s, t.kernels, t.top_ops(),
                         [_reading(run, m) for m in (
                             "device.idle_share.train", "device.idle_share.decode",
                             "model.mfu.train", "model.mfu.decode",
                             "kernels.attention_roofline.train", "kernels.norm_roofline.train")]))
    assert readings[0] == readings[1]
    assert readings[0][4][0] == pytest.approx(65.0)


def test_gaps_are_named_by_the_innermost_span():
    b = program_spans.breakdown(EVENTS + PROGRAM)
    gaps = dict(b["idle_gaps"])
    # [0, 100): mid 50 in tasu.front_half, inside tasu.step and train.step;
    # [250, 400): mid 325 in tasu.front_half; [500, 700): mid 600, where
    # train.step ends and train.data_wait starts (the later names it);
    # [800, 1000): mid 900 in tasu.data.wait, inside train.data_wait
    assert gaps == pytest.approx({"tasu.front_half": 250e-6, "train.data_wait": 200e-6,
                                  "tasu.data.wait": 200e-6})
    assert b["idle_s"] == pytest.approx(650e-6)
    assert b["idle_in_train_step_s"] == pytest.approx(450e-6)
    assert b["idle_in_train_step_named_share"] == pytest.approx(250 / 450)
    assert b["idle_named_by_program_share"] == pytest.approx(450 / 650)


def test_launches_and_syncs_are_put_down_to_the_spans_over_them():
    b = program_spans.breakdown(EVENTS + PROGRAM)
    step = b["spans"]["tasu.step"]
    assert (step["calls"], step["launches"], step["syncs"]) == (1, 4, 1)
    assert b["spans"]["tasu.front_half"]["launches_per_call"] == 2
    assert b["spans"]["tasu.backward"]["launches"] == 1
    assert b["runtime_by_innermost_span"] == {
        "tasu.front_half": {"launches": 2, "syncs": 1}, "tasu.llm": {"launches": 1, "syncs": 0},
        "tasu.backward": {"launches": 1, "syncs": 0},
        "tasu.data.wait": {"launches": 0, "syncs": 1}}
    assert b["syncs_by_operator"] == {"tasu.front_half": {"aten::nonzero": 1},
                                      "tasu.data.wait": {"no operator": 1}}


RECORD = {"spans": {"pool.admit": {"calls": 11, "seconds": 0.2},
                    "pool.refill": {"calls": 4, "seconds": 1.0},
                    "pool.refill/front_half": {"calls": 4, "seconds": 0.6},
                    "pool.launch": {"calls": 50, "seconds": 2.5},
                    "pool.harvest": {"calls": 50, "seconds": 1.5},
                    "pool.harvest/pool.harvest_wait": {"calls": 50, "seconds": 1.2},
                    "data.wait": {"calls": 40, "seconds": 0.03},
                    "step": {"calls": 20, "seconds": 8.0},
                    "step/front_half": {"calls": 20, "seconds": 3.0}},
          "counts": {"pool.requests": 10, "pool.chunks": 50, "pool.slot_steps": 50 * 32 * 8,
                     "pool.tokens": 3200, "pool.slot_s": 640.0}}


@pytest.mark.parametrize("name,value", [
    ("pool.admit_ms.decode", 20.0),
    ("pool.refill_ms.decode", 100.0),
    ("pool.launch_ms.decode", 50.0),
    ("pool.harvest_wait_share.decode", 15.0),
    ("pool.occupancy.decode", 25.0),
    ("pool.slot_tokens_per_s.decode", 5.0),
    ("data.queue_wait_ms.train", 30.0),
    ("step.front_half_ms.train", 150.0),
])
def test_each_reader_reads_the_programs_record(name, value, monkeypatch):
    run = harness.Run(cell={}, cfg={}, mix={}, seed=0, seconds=1, trace=True, device="cpu",
                      t0=0.0, workdir="")
    run.facts["window_s"] = 8.0
    monkeypatch.setattr(program_spans, "recorded", lambda: RECORD)
    assert _reading(run, name) == pytest.approx(value)
    monkeypatch.setattr(program_spans, "recorded", lambda: {"spans": {}, "counts": {}})
    assert _reading(run, name) is None
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    assert _reading(run, name) is None


def test_a_program_without_a_record_gives_none(monkeypatch):
    """The parent of this reader: ``utils.profiler`` without ``recorded``."""
    stub = types.ModuleType("ps_slm_tpu_torch.utils.profiler")
    monkeypatch.setitem(sys.modules, "ps_slm_tpu_torch.utils.profiler", stub)
    import ps_slm_tpu_torch.utils as utils
    monkeypatch.setattr(utils, "profiler", stub, raising=False)
    assert program_spans.recorded() is None
