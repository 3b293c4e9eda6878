"""A later change adds a configuration, a traffic mix, a per-layer metric
and a cell by new files and entries alone: in a copy of the benchmark,
the new cell runs and reports the new metric, and no file that was there
changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from portbench import harness

ROOT = os.path.dirname(harness.HERE)


def _digests(top):
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                out[os.path.relpath(p, top)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_new_files_make_a_new_cell(tmp_path):
    copy = tmp_path / "bench"
    shutil.copytree(harness.HERE, copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy / "BENCHMARK.json")
    before = _digests(copy / "portbench")

    pb = copy / "portbench"
    cfg = json.load(open(pb / "configs" / "tasu-sv-small-qwen2.5-1.5b.json"))
    cfg["name"] = "tasu-copy"
    json.dump(cfg, open(pb / "configs" / "tasu-copy.json", "w"))
    mix = json.load(open(pb / "traffic" / "train_half_audio.json"))
    mix["batch_budget"] = 500
    json.dump(mix, open(pb / "traffic" / "train_small_batches.json", "w"))
    (pb / "metrics" / "steps.traced.train.py").write_text(
        'UNIT, LAYER, MOVES = "steps", "training step", "train_tokens_per_s"\n\n\n'
        'def read(run):\n    steps = run.facts.get("steps")\n'
        '    return None if steps is None else len(steps)\n')
    bench = json.load(open(copy / "BENCHMARK.json"))
    bench["configs"].append({"name": "tasu-copy", "source": "https://example.org/copy",
                             "file": "portbench/configs/tasu-copy.json", "reduced": [],
                             "why": "a copy"})
    bench["workloads"].append({"name": "copy.small", "config": "tasu-copy",
                               "traffic": "train_small_batches", "chips": 1, "why": "a copy"})
    bench["per_layer"].append({"name": "steps.traced.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "training step",
                               "moves": "train_tokens_per_s", "workloads": ["copy.small"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("copy.small")
    json.dump(bench, open(copy / "BENCHMARK.json", "w"))

    code = ("import json, sys; from portbench.tests.tiny import run_cell; "
            "out, run = run_cell('copy.small', trace=True); print(json.dumps(out))")
    env = dict(os.environ, PYTHONPATH=f"{copy}{os.pathsep}{ROOT}")
    res = subprocess.run([sys.executable, "-c", code], cwd=copy, env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["metrics"]["steps.traced.train"]["value"] >= 1
    after = _digests(pb)
    assert {k: after[k] for k in before} == before
