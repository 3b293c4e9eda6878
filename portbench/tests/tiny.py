"""Small widths for running cells on the CPU in tests: the LLM keeps its
vocabulary (the stand-in tokenizer's special ids sit at 151 643-151 646),
the encoder its 560-wide input (80 mel x 7); float32.  Cells that
``BENCHMARK.json`` does not hold yet (PERF.md, Open questions) run from
their files here."""

import copy
import json
import os

from portbench import harness

TINY = {"config": {"dtype": "float32"},
        "encoder": {"output_size": 16, "attention_heads": 2, "linear_units": 32, "num_blocks": 2,
                    "tp_blocks": 1, "kernel_size": 5, "vocab_size": 64},
        "llm": {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
                "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16},
        "traffic": {"utterances": 8, "seconds": [1.0, 3.0], "batch_budget": 700,
                    "trace_seconds": 1, "sample_tokens": 20, "slots": 3, "passes": 4,
                    "batch_seconds": 6, "sample_utterances": 3}}
SEED = 2 ** 31 + 12345
LATER = {
    "tasu15.train_text_only": ("tasu-sv-small-qwen2.5-1.5b", "train_text_only",
                               "portbench/configs/tasu-sv-small-qwen2.5-1.5b.json"),
    "svsmall.asr_backlog": ("sensevoice-small", "asr_backlog",
                            "portbench/configs/sensevoice-small.json"),
}


def bench_with(cell):
    """``BENCHMARK.json``, with ``cell`` added from its files when it is
    one of the cells it does not hold yet."""
    bench = json.load(open(os.path.join(os.path.dirname(harness.HERE), "BENCHMARK.json")))
    if cell in LATER and all(w["name"] != cell for w in bench["workloads"]):
        config, mix, path = LATER[cell]
        bench["workloads"].append({"name": cell, "config": config, "traffic": mix, "chips": 1})
        if all(c["name"] != config for c in bench["configs"]):
            bench["configs"].append({"name": config, "file": path})
    return bench


def run_cell(cell, trace=False, seconds=1.0, control=None, seed=SEED, bench=None, sizes=None):
    from portbench import run

    sizes = copy.deepcopy(sizes or TINY)
    if cell.startswith("svsmall"):
        sizes["encoder"]["vocab_size"] = 25055      # the rich labels' ids
    return run.execute(cell, seed, seconds, trace, device="cpu", sizes=sizes, control=control,
                       bench=bench or bench_with(cell))
