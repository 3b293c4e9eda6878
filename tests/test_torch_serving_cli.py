"""PyTorch port: the serving recipe ``scripts/decode_serving.sh`` through
the decode CLI against the JAX CLI.

On the asset layout of ``tests/test_torch_decode_cli.py`` (tiny widths,
fp32, ``max_new_tokens=8``), each serving mode with
``quantization=true`` must write ``_pred`` and ``_gt`` files
byte-identical to the JAX CLI's: the greedy slot pool, CTC-draft
speculative decoding (static batches), both together, the beam pool, and
the int8 KV cache.  The script's argv, in each ``MODE``, parses to the
same config in both packages.
"""

import pytest

import chip_smoke
from ps_slm_tpu.config import RunConfig as JaxRunConfig
from ps_slm_tpu.config import parse_cli as jax_parse_cli
from ps_slm_tpu.config import to_dict as jax_to_dict
from ps_slm_tpu_torch import config as pconfig
from test_torch_decode_cli import MAX_NEW, TINY, _decode_both, assets  # noqa: F401

MODES = {
    "continuous": ["++train_config.continuous_batching=true", "++train_config.decode_slots=3"],
    "speculative": ["++train_config.speculative_ctc=true", "++train_config.spec_window=4"],
    "continuous_speculative": ["++train_config.continuous_batching=true",
                               "++train_config.decode_slots=3",
                               "++train_config.speculative_ctc=true",
                               "++train_config.spec_window=4"],
    "continuous_beam": ["++train_config.continuous_batching=true",
                        "++train_config.decode_slots=2", "++train_config.num_beams=2"],
    "kv_cache_bits_8": ["++train_config.kv_cache_bits=8"],
}


@pytest.mark.parametrize("mode", list(MODES))
def test_serving_modes_decode_files_equal_jax(assets, tmp_path, mode):  # noqa: F811
    args = chip_smoke.serving_args(assets, "plain", "unused", MAX_NEW, llm_dim=64,
                                   encoder_dim=11)
    args = [a for a in args if not a.startswith(("decode_log=", "++log_config"))]
    args += TINY + MODES[mode] + [f"++log_config.log_file={tmp_path}/log.txt"]
    assert "++train_config.quantization=true" in args
    files = _decode_both(args, args, tmp_path)
    assert files["jax", "_pred"] == files["port", "_pred"]
    assert files["jax", "_gt"] == files["port", "_gt"]
    keys = sorted(line.split(b"\t")[0] for line in files["port", "_gt"].splitlines())
    assert keys == sorted([b"ark00", b"ark01", b"ark02", b"ark03", b"wav00", b"flac00"])


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict) and (k.endswith("config") or k == "fbank"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("mode", ["continuous", "speculative", "plain"])
def test_decode_serving_argv_parses_as_in_jax(mode):
    env = {"LLM": "/m/llm", "ENCODER": "/m/enc", "DATA": "/d", "CKPT": "/c.bin", "LOG": "/l",
           "MODE": mode}
    argv = chip_smoke.recipe_args("decode_serving", env, cli="decode")
    assert "++train_config.quantization=true" in argv
    port = _flat(pconfig.to_dict(pconfig.parse_cli(argv)))
    want = _flat(jax_to_dict(jax_parse_cli(argv, JaxRunConfig())))
    for arg in argv:
        assert arg.split("=", 1)[0].lstrip("+") in port, arg
    common = sorted(set(port) & set(want))
    assert {"train_config.quant_bits", "train_config.q4_group_size",
            "train_config.spec_window", "train_config.decode_slots"} <= set(common)
    assert {k: port[k] for k in common} == {k: want[k] for k in common}
    assert port["train_config.continuous_batching"] == (mode == "continuous")
    assert port["train_config.speculative_ctc"] == (mode == "speculative")
