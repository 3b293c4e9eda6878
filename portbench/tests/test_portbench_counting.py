"""``counting.py`` against hand counts."""

import pytest

from portbench import counting

ENC = {"input_size": 8, "output_size": 4, "attention_heads": 2, "linear_units": 6,
       "num_blocks": 2, "tp_blocks": 1, "kernel_size": 3, "vocab_size": 5}
LLM = {"hidden_size": 4, "intermediate_size": 6, "num_hidden_layers": 2,
       "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 2, "vocab_size": 10}
CFG = {"encoder": ENC, "llm": LLM, "projector": {"hidden": 3}}


def test_causal_attention_counts_the_lower_triangle():
    f, b = counting.attention(4, heads=2, kv_heads=1, head_dim=3, causal=True)
    assert f == 4 * (4 * 5 / 2) * 2 * 3           # QK^T and PV over the 10 pairs, 2 FLOPs a MAC
    assert b == 2 * (4 * 2 * 3 * 2) + 2 * 4 * 1 * 3 * 2 + 4 * 2 * 4


def test_full_attention_counts_every_pair_and_backward_doubles():
    f, _ = counting.attention(4, heads=1, kv_heads=1, head_dim=2, causal=False)
    assert f == 4 * 16 * 2
    fb, bb = counting.attention(4, heads=1, kv_heads=1, head_dim=2, causal=False, backward=True)
    assert fb == 2 * f and bb == 3 * (4 * 2 * 2) + 2 * (2 * 4 * 2 * 2) + 4 * 4


def test_norm_bytes():
    assert counting.norm(3, 5)[1] == 2 * 15 * 2 + 3 * 8 + 2 * 5 * 2
    assert counting.norm(3, 5, backward=True)[1] == 3 * 15 * 2 + 3 * 8
    assert counting.norm(3, 5, backward=True, param_grads=True)[1] == 3 * 15 * 2 + 3 * 8 + 20


def test_encoder_flops_by_hand():
    n = 3                          # 2 + 1 blocks
    length = 5
    qkv = 2 * length * 3 * 4 * (8 + 2 * 4)
    rest = 2 * length * n * (16 + 3 * 4 + 2 * 4 * 6)
    att = n * 4 * 25 * 2 * 2
    head = 2 * length * 4 * 5
    assert counting.encoder_flops(ENC, length) == qkv + rest + att + head


def test_llm_flops_by_hand():
    f = counting.llm_flops(LLM, 3, unembed_rows=2)
    assert f["proj"] == 2 * 3 * 2 * (2 * 4 * 4 + 2 * 4 * 2)
    assert f["mlp"] == 2 * 3 * 2 * 3 * 4 * 6
    assert f["attn"] == 2 * 4 * 6 * 2 * 2                    # 6 causal pairs, 2 layers
    assert f["unembed"] == 2 * 2 * 4 * 10


def test_train_step_model_flops_by_hand():
    row = {"enc": 5, "kept": 2, "text": 3, "labels": 2}
    w = counting.train_step(CFG, [row])
    merged = 3 + 2 - 1
    lf = counting.llm_flops(LLM, merged, 2)
    proj = 2 * 2 * (5 * 3 + 3 * 4)
    want = (counting.encoder_flops(ENC, 5) + 3 * proj + sum(lf.values())
            + lf["proj"] + lf["mlp"] + lf["unembed"] + 2 * lf["attn"])
    assert w["model"][0] == pytest.approx(want)
    no_enc = counting.train_step(CFG, [row], encoder=False)
    assert no_enc["model"][0] == pytest.approx(want - counting.encoder_flops(ENC, 5))


def test_decode_least_time_reads_weights_once_a_step():
    req = {"enc": 5, "kept": 2, "text": 3, "tokens": 5}
    one = counting.decode_least_seconds(CFG, [req], slots=8)
    two = counting.decode_least_seconds(CFG, [req, req], slots=8)
    w = counting.llm_weight_bytes(LLM, 1.0)
    # 4 decode tokens a request: both requests' tokens share one step's read
    assert two - 2 * one == pytest.approx(-w / counting.PEAK_BYTES)


def test_least_seconds_is_the_larger_bound():
    assert counting.least_seconds(989e12, 0) == 1.0
    assert counting.least_seconds(0, 3.35e12) == 1.0
