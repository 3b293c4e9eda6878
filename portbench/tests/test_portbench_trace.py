"""The device trace's reduction: busy time as the union of the device's
intervals, the idle share, idle gaps named by the harness span over them,
and the rooflines' division by the named kernels' time."""

import importlib

import pytest

from portbench import counting, harness


class Ev:
    def __init__(self, name, dev, start_us, dur_us):
        self._n, self._d, self._s, self._u = name, dev, start_us * 1000, dur_us * 1000

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


EVENTS = [
    Ev("portbench.window", "CPU", 0, 1000),
    Ev("portbench.train.step", "CPU", 0, 600),
    Ev("portbench.train.data_wait", "CPU", 600, 400),
    Ev("void flash_fwd_bf16_kernel<64>(...)", "CUDA", 100, 100),
    Ev("void ps::layer_norm_fwd_kernel<bf16>(...)", "CUDA", 150, 100),     # overlaps the flash one
    Ev("ampere_bf16_gemm", "CUDA", 400, 100),
    Ev("vectorized_layer_norm_kernel", "CUDA", 700, 100),
    Ev("outside", "CUDA", 1200, 100),                                     # after the window
]


def test_busy_is_the_union_inside_the_window():
    t = harness.summarize(EVENTS)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(350e-6)          # [100, 250) + [400, 500) + [700, 800)
    assert 100.0 * (1 - t.busy_s / t.window_s) == pytest.approx(65.0)


def test_gaps_are_named_by_the_innermost_span():
    t = harness.summarize(EVENTS)
    gaps = dict(t.top_gaps())
    assert gaps["train.step"] == pytest.approx(100e-6 + 150e-6)            # [0,100) [250,400)
    assert gaps["train.data_wait"] == pytest.approx(200e-6 + 200e-6)       # [500,700) [800,1000)
    ops = dict(t.top_ops())
    assert "outside" not in ops and len(ops) == 4


def _metric(name):
    return harness.load_metric(name)


def test_rooflines_divide_by_their_kernels_only():
    t = harness.summarize(EVENTS)
    att = _metric("kernels.attention_roofline.train")
    norm = _metric("kernels.norm_roofline.train")
    assert t.kernel_seconds(lambda n: att.KERNELS.search(n) is not None) == pytest.approx(100e-6)
    # the port's LayerNorm kernel, not PyTorch's vectorized one
    assert t.kernel_seconds(lambda n: norm.KERNELS.search(n) is not None) == pytest.approx(100e-6)


def test_roofline_from_a_synthetic_step():
    cfg = {"encoder": {"input_size": 560, "output_size": 512, "attention_heads": 4,
                       "linear_units": 2048, "num_blocks": 50, "tp_blocks": 20, "kernel_size": 11,
                       "vocab_size": 25055},
           "llm": {"hidden_size": 1536, "intermediate_size": 8960, "num_hidden_layers": 28,
                   "num_attention_heads": 12, "num_key_value_heads": 2, "head_dim": 128,
                   "vocab_size": 151936},
           "projector": {"hidden": 2048}}
    rows = [{"enc": 200, "kept": 60, "text": 90, "labels": 40}]
    work = counting.train_step(cfg, rows)["attention"]
    least = counting.least_seconds(*work)
    run = harness.Run(cell={}, cfg=cfg, mix={}, seed=0, seconds=1, trace=True, device="cpu",
                      t0=0.0, workdir="")
    run.facts["steps"] = [{"rows": rows}]
    run.trace_summary = harness.TraceSummary(1.0, 0.5, [("flash_fwd_bf16_kernel", 0.0, 4 * least)],
                                             [])
    assert _metric("kernels.attention_roofline.train").read(run) == pytest.approx(25.0)
    assert _metric("device.idle_share.train").read(run) == pytest.approx(50.0)
    run.trace_summary = harness.TraceSummary(1.0, 0.5, [("gemm", 0.0, 1.0)], [])
    assert _metric("kernels.attention_roofline.train").read(run) is None


def test_every_metric_file_names_its_unit_layer_and_moves():
    import json
    import os

    bench = json.load(open(os.path.join(harness.HERE, "..", "BENCHMARK.json")))
    for m in bench["per_layer"]:
        mod = _metric(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"], m["moves"])
        assert callable(mod.read)
    assert importlib.import_module("portbench.counting").PEAK_FLOPS == 989e12
