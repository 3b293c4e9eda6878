"""The DeepSeek-V3 configuration's benchmark pieces: ``counting_deepseek_v3``
against hand counts, the three new per-layer readers on a fabricated run
(and silent on a program without the kernels or tallies), the
configuration file against the published config, and the new cell run in
a copy of the benchmark at tiny widths on the CPU, leaving every file of
the benchmark as it was."""

import copy
import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import counting, harness, program_spans
from portbench import counting_deepseek_v3 as cd
from portbench.tests.tiny import TINY

ROOT = os.path.dirname(harness.HERE)
LLM = {"hidden_size": 4, "intermediate_size": 10, "moe_intermediate_size": 6,
       "num_hidden_layers": 3, "num_attention_heads": 2, "n_routed_experts": 5,
       "n_shared_experts": 2, "num_experts_per_tok": 2, "first_k_dense_replace": 1,
       "kv_lora_rank": 3, "qk_nope_head_dim": 2, "qk_rope_head_dim": 1, "v_head_dim": 2,
       "vocab_size": 7}
ENC = {"input_size": 8, "output_size": 4, "attention_heads": 2, "linear_units": 6,
       "num_blocks": 2, "tp_blocks": 1, "kernel_size": 3, "vocab_size": 5}
CFG = {"encoder": ENC, "llm": LLM, "projector": {"hidden": 3}}
TINY_LLM = dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
                num_hidden_layers=3, num_attention_heads=4, n_routed_experts=8,
                num_experts_per_tok=3, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16)


def test_mla_attention_by_hand():
    f, b = cd.mla_attention(4, heads=2, qk_dim=3, v_dim=2)
    assert f == 2 * 10 * 2 * (3 + 2)                 # 10 causal pairs, q.k then p.v
    assert b == 4 * 2 * (2 * 3 + 2 * 2) * 2 + 4 * 2 * 4


def test_moe_by_hand():
    f, b = cd.moe(LLM, rows=3, experts_read=2)
    assert cd.expert_params(LLM) == 3 * 4 * 6
    assert f == 2 * 3 * 72
    assert b == 2 * 72 * 2 + 3 * (4 * 2 + 4 * 4)
    tallies = {"moe.rows": [[[1, 2, 0, 0, 0]] * 3, [[30, 0, 0, 0, 0]] * 3],
               "moe.experts_read": [[2, 2, 2], [1, 1, 1]]}
    want = (counting.least_seconds(*cd.moe(LLM, 9, 6))
            + counting.least_seconds(*cd.moe(LLM, 90, 3)))
    assert cd.moe_least_seconds(LLM, tallies) == pytest.approx(want)


def test_dense_params_and_cells_by_hand():
    p = cd.dense_params(LLM)
    assert p["attn"] == 3 * (4 * 2 * 3 + 4 * 4 + 3 * 2 * 4 + 2 * 2 * 4)
    assert p["dense_mlp"] == 1 * 3 * 4 * 10
    assert p["shared"] == 2 * (3 * 4 * 6 * 2 + 4 * 5)
    assert p["head"] == 4 * 7
    assert cd.latent_cell_bytes(LLM) == 3 * (3 + 1) * 2
    assert cd.absorbed_flops(LLM, 5) == 3 * 2.0 * 2 * (2 * 3 + 5 * 4 + 5 * 3 + 3 * 2)


def test_prefill_flops_by_hand():
    p = cd.dense_params(LLM)
    per_pos = 2 * (p["attn"] + p["dense_mlp"] + p["shared"] + 2 * 2 * 72)
    att = 3 * cd.mla_attention(4, 2, 3, 2)[0]
    assert cd.prefill_flops(LLM, 4) == 4 * per_pos + att + 2 * p["head"]


def test_decode_least_time_reads_the_dense_weights_once_a_step():
    req = {"enc": 5, "kept": 2, "text": 3, "tokens": 5}
    one = cd.decode_least_seconds(CFG, [req], slots=8, step_experts_read=0)
    two = cd.decode_least_seconds(CFG, [req, req], slots=8, step_experts_read=0)
    dense = sum(cd.dense_params(LLM).values()) * 2
    assert two - 2 * one == pytest.approx(-dense / counting.PEAK_BYTES)
    more = cd.decode_least_seconds(CFG, [req], slots=8, step_experts_read=10)
    assert more - one == pytest.approx(10 * 72 * 2 / counting.PEAK_BYTES)


def _run(cfg=None, facts=None, kernels=()):
    run = harness.Run(cell={}, cfg=cfg or CFG, mix={}, seed=0, seconds=1, trace=True,
                      device="cpu", t0=0.0, workdir="")
    run.facts.update(facts or {})
    run.trace_summary = harness.TraceSummary(2.0, 1.0, list(kernels), [])
    return run


TALLIES = {"moe.rows": [[[1, 2, 0, 0, 0]] * 3, [[30, 0, 0, 0, 0]] * 3],
           "moe.experts_read": [[2, 2, 2], [1, 1, 1]]}
REQ = {"enc": 5, "kept": 2, "text": 3, "tokens": 5}


def _reading(name, run):
    return harness.load_metric(name).read(run)


def test_mla_roofline_reads_the_named_kernel_over_the_windows_prefills():
    kernels = [("void flash_fwd_mla_bf16_kernel(...)", 0.1, 1e-6),
               ("void flash_fwd_bf16_kernel(...)", 0.2, 5.0)]
    run = _run(facts={"prefills": [REQ, REQ]}, kernels=kernels)
    least = 2 * 3 * counting.least_seconds(*cd.mla_attention(4, 2, 3, 2))
    got = _reading("kernels.mla_attention_roofline.decode_moe", run)
    assert got == pytest.approx(100 * least / 1e-6)
    assert _reading("kernels.mla_attention_roofline.decode_moe",
                    _run(facts={"prefills": [REQ]}, kernels=kernels[1:])) is None


def test_moe_roofline_reads_the_tallies_and_the_grouped_kernels(monkeypatch):
    kernels = [("moe_grouped_gemm_gate_up_0d1d2d", 0.1, 2e-6),
               ("moe_grouped_gemm_down_0d1d", 0.2, 1e-6), ("other", 0.3, 9.0)]
    monkeypatch.setattr(program_spans, "recorded",
                        lambda: {"spans": {}, "counts": {}, "tallies": TALLIES})
    got = _reading("kernels.moe_roofline.decode_moe", _run(kernels=kernels))
    assert got == pytest.approx(100 * cd.moe_least_seconds(LLM, TALLIES) / 3e-6)
    monkeypatch.setattr(program_spans, "recorded", lambda: {"spans": {}, "counts": {}})
    assert _reading("kernels.moe_roofline.decode_moe", _run(kernels=kernels)) is None


def test_mfu_reads_requests_and_the_step_tallies(monkeypatch):
    facts = {"requests": [REQ], "window_s": 2.0, "slots": 8}
    monkeypatch.setattr(program_spans, "recorded",
                        lambda: {"spans": {}, "counts": {}, "tallies": TALLIES})
    got = _reading("model.mfu.decode_moe", _run(facts=facts))
    assert got == pytest.approx(100 * cd.decode_least_seconds(CFG, [REQ], 8, 6) / 2.0)
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    assert _reading("model.mfu.decode_moe", _run(facts=facts)) is None


def test_the_configuration_holds_the_published_config():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    conf = next(c for c in bench["configs"] if c["name"] == "tasu-sv-small-moonlight-16b-a3b")
    cfg = json.load(open(os.path.join(ROOT, conf["file"])))
    assert conf["reduced"] == cfg["reduced"] == []
    assert cfg["llm"]["model_type"] == "deepseek_v3"
    for key, value in cfg["llm"].items():
        assert cfg[key] == value, key
    assert (cfg["llm"]["hidden_size"], cfg["llm"]["n_routed_experts"],
            cfg["llm"]["num_experts_per_tok"], cfg["llm"]["num_hidden_layers"]) == (2048, 64, 6, 27)
    serving = cfg["recipes"]["decode_serving"]["train_config"]
    assert serving["quantization"] is False and serving["kv_cache_bits"] == 16


def _digests(top):
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                out[os.path.relpath(p, top)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_the_new_cell_runs_in_a_copy_and_leaves_the_benchmark_as_it_was(tmp_path):
    """In a copy of the benchmark: the cell runs on the CPU at tiny widths,
    traced, correct, with its readings and the readers that need no device
    kernel; no file of the benchmark changes."""
    copy_root = tmp_path / "bench"
    shutil.copytree(harness.HERE, copy_root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy_root / "BENCHMARK.json")
    before = _digests(copy_root)
    sizes = copy.deepcopy(TINY)
    sizes["llm"] = TINY_LLM
    code = ("import json; from portbench.tests.tiny import run_cell; "
            f"out, run = run_cell('moon16.decode_backlog', trace=True, sizes={sizes!r}); "
            "print(json.dumps({'out': out, 'readings': run.readings}))")
    env = dict(os.environ, PYTHONPATH=f"{copy_root}{os.pathsep}{ROOT}")
    res = subprocess.run([sys.executable, "-c", code], cwd=copy_root, env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    out, readings = got["out"], got["readings"]
    assert out["correct"], out["checks"]
    assert out["checks"]["served_gap"]["value"] <= 1e-3          # fp32 on both sides
    assert readings["route_flips"] == 0.0 and readings["route_pairs"] > 0
    assert "model.mfu.decode_moe" in out["metrics"]
    assert "kernels.moe_roofline.decode_moe" not in out["metrics"]    # no kernel on the CPU
    assert _digests(copy_root) == before


def test_a_router_one_expert_short_fails_the_cell(monkeypatch):
    """A planted routing fault, each token's top k - 1 in the program: the
    reference follows the served sets, so the logits agree, and the sets
    are held apart by ``route_margin``."""
    from ps_slm_tpu_torch.ops import moe

    from portbench.tests.tiny import run_cell

    route = moe.route
    monkeypatch.setattr(moe, "route", lambda y, g, b, k, s, n=True: route(y, g, b, k - 1, s, n))
    sizes = copy.deepcopy(TINY)
    sizes["llm"] = TINY_LLM
    out, run = run_cell("moon16.decode_backlog", sizes=sizes)
    assert not out["correct"], out["checks"]
    assert out["checks"]["route_margin"]["value"] > out["checks"]["route_margin"]["limit"]
    assert run.readings["route_flips"] == 1.0


def test_the_served_sets_are_the_ones_the_reference_follows():
    """Sound at tiny widths in fp32: every served set is the reference's own
    top k (no margin, no flip), and the served tokens are its first
    choices; the fp8 control departs from both."""
    from portbench.tests.tiny import run_cell

    sizes = copy.deepcopy(TINY)
    sizes["llm"] = TINY_LLM
    out, run = run_cell("moon16.decode_backlog", sizes=sizes)
    assert out["correct"], out["checks"]
    assert out["checks"]["route_margin"]["value"] == 0.0
    assert out["checks"]["served_gap"]["value"] <= 1e-3
    assert run.readings["prompt_same_length"] == 1.0
    fp8, run8 = run_cell("moon16.decode_backlog", sizes=sizes, control="fp8")
    assert fp8["checks"]["route_margin"]["value"] > 0.0
    assert run8.readings["route_flips"] > 0.0


def test_deficit_reads_how_far_a_set_departs_from_the_top_k():
    """By hand, scores 0.9, 0.8, 0.7, 0.65, 0.1 and k = 3: the top 3 reads
    0; swapping the third for the fourth reads 0.05 (their gap); the top 2
    alone (a router one short) reads 0.05 too (the third over the fourth);
    taking the last for the third reads 0.6 (the third over it)."""
    import torch

    from portbench.reference import deepseek_v3 as ref

    biased = torch.tensor([[0.9, 0.8, 0.7, 0.65, 0.1]] * 4)
    chosen = [torch.tensor([[0, 1, 2]]), torch.tensor([[0, 1, 3]]), torch.tensor([[0, 1]]),
              torch.tensor([[0, 1, 4]])]
    got = [float(ref.deficit(biased[:1], c, 3)) for c in chosen]
    assert got == pytest.approx([0.0, 0.05, 0.05, 0.6])

