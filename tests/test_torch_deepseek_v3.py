"""PyTorch port: the DeepSeek-V3 decoder (latent attention, sigmoid-routed
experts) against the plain float32 reference of the benchmark
(``portbench/reference/deepseek_v3.py``), at tiny widths on the CPU.

Tolerances.  The port and the reference compute the same fp32 products in
another order (the port's fused projections, its batched einsums, its
fp32 sum of the k expert outputs in another order than the reference's
``index_add``): logits agree to ~2e-6 of a scale of ~4, so ``TOL`` is
1e-4 absolute (and relative), some fifty times the observed difference,
and far below what one lost expert or one dropped rotary pair changes
(the faults below read 1e-2 and more).  The served-token gap of the pool
is held to the same 1e-4: an fp32 argmax of the same logits.
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from portbench.reference import deepseek_v3 as ref
from portbench.reference import tasu as ref_tasu
from ps_slm_tpu_torch.cli import decode
from ps_slm_tpu_torch.config import ModelConfig, TrainConfig
from ps_slm_tpu_torch.inference.continuous import ContinuousGreedyDecoder
from ps_slm_tpu_torch.models import deepseek_v3 as ds
from ps_slm_tpu_torch.models import tasu
from ps_slm_tpu_torch.models.quantization import quantize_llm
from ps_slm_tpu_torch.ops import moe
from ps_slm_tpu_torch.training.step import TrainStep
from ps_slm_tpu_torch.utils import profiler

TOL = dict(atol=1e-4, rtol=1e-4)
HF = dict(model_type="deepseek_v3", vocab_size=256, hidden_size=64, intermediate_size=96,
          moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
          n_routed_experts=8, n_shared_experts=2, num_experts_per_tok=3, first_k_dense_replace=1,
          kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
          rope_theta=10000.0, rms_norm_eps=1e-5, routed_scaling_factor=2.446,
          norm_topk_prob=True, q_lora_rank=None, scoring_func="sigmoid",
          topk_method="noaux_tc", n_group=1, topk_group=1)


def _perturb(module, seed=1):
    """Norm weights 1 + N(0, 0.05^2) and correction biases N(0, 0.01^2) over
    the factory's init (1 and 0), so that both act."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("e_score_correction_bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.01)
            elif name.endswith("norm.weight"):
                p.copy_(1 + torch.randn(p.shape, generator=g) * 0.05)


def _llm(seed=0, **over):
    llm = ds.DeepseekV3Model(ds.DeepseekV3Config.from_hf(dict(HF, **over)))
    llm.init_weights(torch.Generator().manual_seed(seed))
    _perturb(llm, seed + 1)
    return llm.eval()


def _ref_logits(llm, embeds, **kw):
    w = llm.state_dict()
    return ref.logits(w, ref.forward(w, HF, embeds, **kw))


def test_forward_logits_match_reference():
    llm = _llm()
    x = torch.randn(1, 13, 64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        hidden, _ = llm(x, None, torch.arange(13)[None])
        want = _ref_logits(llm, x[0])
    torch.testing.assert_close(llm.unembed(hidden)[0], want, **TOL)


def test_prefill_then_latent_cache_steps_match_reference():
    """A left-padded B=2 prefill into the latent cache, then one-token
    steps in the absorbed form, each row at its own offset: every step's
    logits are the reference's full forward at that position."""
    llm = _llm()
    g = torch.Generator().manual_seed(3)
    lens, steps, pad = [9, 5], 4, 9
    rows = [torch.randn(n + steps, 64, generator=g) for n in lens]
    cap = pad + steps
    cache = llm.init_cache(2, cap, torch.float32, "cpu")
    assert [tuple(t.shape) for t in cache[0]] == [(2, cap, 32), (2, cap, 8)]
    emb = torch.zeros(2, pad, 64)
    mask = torch.zeros(2, cap, dtype=torch.bool)
    pos = torch.zeros(2, pad, dtype=torch.long)
    for i, n in enumerate(lens):
        emb[i, pad - n:] = rows[i][:n]
        mask[i, pad - n:pad] = True
        pos[i, pad - n:] = torch.arange(n)
    got = [[] for _ in lens]
    with torch.no_grad():
        hidden, _ = llm(emb, mask, pos, cache, 0)
        for i in range(2):
            got[i].append(llm.unembed(hidden[i, -1:])[0])
        for t in range(steps):
            mask[:, pad + t] = True
            step = torch.stack([rows[i][lens[i] + t] for i in range(2)])[:, None]
            p = torch.tensor([[n + t] for n in lens])
            hidden, _ = llm(step, mask, p, cache, torch.full((2,), pad + t))
            for i in range(2):
                got[i].append(llm.unembed(hidden[i])[0])
        for i, n in enumerate(lens):
            want = _ref_logits(llm, rows[i])[n - 1:]
            torch.testing.assert_close(torch.stack(got[i]), want, **TOL)


def _pool_requests(n=7, prefill=10):
    from types import SimpleNamespace

    g = torch.Generator().manual_seed(4)
    reqs = {}
    for i in range(n):
        s = int(torch.randint(3, prefill + 1, (1,), generator=g))
        reqs[f"r{i}"] = SimpleNamespace(embeds=torch.randn(1, s, 64, generator=g),
                                        attention_mask=torch.ones(1, s, dtype=torch.bool),
                                        position_ids=torch.arange(s)[None])
    return reqs


def test_greedy_pool_serves_the_references_first_choices():
    """The greedy slot pool (eager on the CPU) over more requests than
    slots: each served token lies within TOL of the reference's best logit
    at its position (teacher-forced), and the pool counted its prefills'
    valid and padded positions."""
    from types import SimpleNamespace

    llm, reqs, prefill, max_new = _llm(), _pool_requests(), 10, 6
    dec = ContinuousGreedyDecoder(SimpleNamespace(llm=llm), merge=lambda b: reqs[b["key"]],
                                  num_slots=3, prefill_len=prefill, max_new_tokens=max_new,
                                  eos_token_id=255, sync_every=2, device="cpu")
    before = profiler.counts()
    got = dict(dec.run((k, {"key": k}) for k in reqs))
    c = {k: v - before.get(k, 0) for k, v in profiler.counts().items()}
    assert c["pool.prefill_valid"] == sum(r.embeds.shape[1] for r in reqs.values())
    assert c["pool.prefill_padded"] == prefill * len(reqs) - c["pool.prefill_valid"]
    assert set(got) == set(reqs)
    for key, toks in got.items():
        assert len(toks) == max_new or 255 not in toks
        r = reqs[key]
        with torch.no_grad():
            seq = torch.cat([r.embeds[0], llm.embed(torch.as_tensor(toks, dtype=torch.long))])
            lg = _ref_logits(llm, seq)[r.embeds.shape[1] - 1:]
        gaps = ref_tasu.gaps(lg, list(toks))
        assert float(gaps.max()) <= TOL["atol"], (key, gaps)


@pytest.mark.parametrize("routing", ["random", "one_expert"])
def test_moe_op_matches_dense_loop(routing):
    """``moe.experts`` against every expert applied to every row and weighted
    by a dense [T, E] matrix (zero where not chosen), including a batch
    that routes every row to one expert."""
    g = torch.Generator().manual_seed(5)
    t, h, i, e, k = 11, 16, 8, 6, 3
    x = torch.randn(t, h, generator=g)
    gate_up, down = torch.randn(e, 2 * i, h, generator=g), torch.randn(e, h, i, generator=g)
    if routing == "random":
        idx = torch.stack([torch.randperm(e, generator=g)[:k] for _ in range(t)])
        w = torch.rand(t, k, generator=g)
    else:
        idx, w = torch.full((t, 1), 4), torch.rand(t, 1, generator=g)
    dense = torch.zeros(t, e).scatter(1, idx, w)
    want = sum(dense[:, j:j + 1] * moe.expert_ref(x, gate_up[j], down[j]) for j in range(e))
    counts = moe.record(idx, e, 0, 1, step=False)
    assert counts.tolist() == torch.bincount(idx.reshape(-1), minlength=e).tolist()
    torch.testing.assert_close(moe.experts(x, idx, w, gate_up, down, counts), want, **TOL)


def test_align_sorts_pairs_by_expert_in_padded_tiles():
    """The grouped kernels' layout, in plain tensor ops: each used tile
    holds one expert's pairs (or the sentinel), every pair once."""
    idx = torch.tensor([[2, 0], [2, 3], [2, 0], [1, 2]])
    counts = torch.bincount(idx.reshape(-1), minlength=5)
    ids, tiles = moe.align(idx, counts, 4)
    m = idx.numel()
    assert ids.numel() == -(-(m + 5 * 3) // 4) * 4 and tiles.numel() == ids.numel() // 4
    flat = idx.reshape(-1)
    for tile, ex in enumerate(tiles.tolist()):
        pairs = [p for p in ids[tile * 4:(tile + 1) * 4].tolist() if p < m]
        if ex == 5:
            assert not pairs
        else:
            assert pairs and all(flat[p] == ex for p in pairs)
    assert sorted(p for p in ids.tolist() if p < m) == list(range(m))
    assert tiles.tolist()[:5] == [0, 1, 2, 3, 5]        # expert 2 fills one tile; 4 has none


def test_correction_bias_chooses_but_does_not_weigh():
    g = torch.Generator().manual_seed(6)
    y, gate = torch.randn(5, 16, generator=g), torch.randn(8, 16, generator=g)
    zero = torch.zeros(8)
    idx0, w0 = moe.route(y, gate, zero, 3, 2.446)
    scores = torch.sigmoid(y @ gate.T)
    bias = zero.clone()
    bias[7] = 5.0                           # expert 7 is chosen by every row
    idx1, w1 = moe.route(y, gate, bias, 3, 2.446)
    assert (idx1 == 7).any(dim=1).all() and not torch.equal(idx0, idx1)
    chosen = scores.gather(1, idx1)
    torch.testing.assert_close(w1, 2.446 * chosen / chosen.sum(-1, keepdim=True))
    torch.testing.assert_close(w0.sum(-1), torch.full((5,), 2.446))


def test_top5_routing_fault_reads_above_the_tolerance():
    """A fault planted in the program (top 2 of 3 experts, as top-5 of
    Moonlight's 6) moves the logits far past TOL."""
    llm = _llm()
    x = torch.randn(1, 9, 64, generator=torch.Generator().manual_seed(7))
    for layer in llm.layers[1:]:
        layer.mlp.top_k = 2
    with torch.no_grad():
        got = llm.unembed(llm(x, None, torch.arange(9)[None])[0])[0]
        want = _ref_logits(llm, x[0])
    assert float((got - want).abs().max()) > 100 * TOL["atol"]


def test_tallies_count_rows_by_expert_while_recording():
    llm = _llm()
    x = torch.randn(2, 5, 64, generator=torch.Generator().manual_seed(8))
    routes = []
    llm.set_routes(routes)
    with torch.no_grad():
        llm(x, None, torch.arange(5)[None].expand(2, 5))            # not recorded
        before = profiler.recorded()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            llm(x, None, torch.arange(5)[None].expand(2, 5))
    llm.set_routes(None)
    rec = profiler.recorded()
    rows = torch.tensor(rec["tallies"]["moe.rows"]) - torch.tensor(
        before["tallies"].get("moe.rows", np.zeros((2, 3, 8), int).tolist()))
    want = torch.zeros(3, 8, dtype=torch.long)
    for layer, idx in zip((1, 2), routes[2:]):
        want[layer] = torch.bincount(idx.reshape(-1), minlength=8)
    assert torch.equal(rows[1], want) and not rows[0].any()
    assert rows.sum() == 2 * 10 * 3
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"tasu.mla", "tasu.moe"} <= names


def test_train_step_projector_gradients_match_reference():
    """half_audio's TrainStep with the frozen decoder: the projector's
    gradients against the reference's autograd from the same pooled
    posterior (one row; the merged prompt is text, audio, text)."""
    tc = TrainConfig(ctc_posterior=True, do_psd=True, freeze_encoder=True, freeze_llm=True,
                     lr=1e-3, warmup_steps=1, seed=3)
    mc = ModelConfig(llm_dim=64, encoder_dim=11, llm_config_overrides=dict(HF),
                     encoder_config_overrides=dict(input_size=24))
    model = tasu.model_factory(tc, mc, device="cpu")
    _perturb(model.llm)
    model.speech_token_id = 7
    rng = np.random.default_rng(9)
    ids = rng.integers(10, 200, size=(1, 8))
    ids[0, 3] = 7
    labels = ids.copy()
    labels[0, :4] = -100
    batch = {"input_ids": torch.from_numpy(ids), "labels": torch.from_numpy(labels),
             "attention_mask": torch.ones(1, 8, dtype=torch.bool),
             "input_features": torch.from_numpy(rng.normal(size=(1, 12, 24)).astype(np.float32)),
             "input_feature_length": torch.tensor([12])}
    seen = []
    hook = model.projector.register_forward_hook(lambda m, a, out: seen.append(a[0].detach()))
    step = TrainStep(model, tc, "cpu")
    proj0 = {k: v.detach().clone() for k, v in model.projector.state_dict().items()}
    step(batch)
    hook.remove()
    got = {k: p.grad for k, p in model.projector.named_parameters()}
    with torch.no_grad():
        n_audio = int(tasu.compute_audio_embeds(model, batch)[1][0])   # PSD's kept frames
    params = {k: v.clone().requires_grad_(True) for k, v in proj0.items()}
    w_llm = model.llm.state_dict()
    table = w_llm["embed_tokens.weight"]
    ids_t = torch.from_numpy(ids[0])
    audio = ref_tasu.project(params, seen[0][0, :n_audio])
    seq = torch.cat([table[ids_t[:3]], audio, table[ids_t[4:]]])
    lg = ref.logits(w_llm, ref.forward(w_llm, HF, seq))
    first = 3 + n_audio                      # the position of text token 4, predicted before it
    tgt = ids_t[4:]
    loss = torch.nn.functional.cross_entropy(lg[first - 1:-1], tgt)
    loss.backward()
    assert n_audio > 0
    for k, p in params.items():
        torch.testing.assert_close(got[k], p.grad, atol=1e-5, rtol=1e-4)


def test_quantize_llm_and_int8_cache_refuse_the_decoder_by_name():
    llm = _llm()
    with pytest.raises(NotImplementedError, match="deepseek_v3"):
        quantize_llm(llm, 8)
    with pytest.raises(NotImplementedError, match="deepseek_v3"):
        llm.init_cache(1, 4, torch.float32, "cpu", kv_bits=8)
    with pytest.raises(NotImplementedError, match="q_lora_rank"):
        ds.DeepseekV3Config.from_hf(dict(HF, q_lora_rank=1536))


def test_hf_checkpoint_round_trip(tmp_path):
    from ps_slm_tpu_torch.tools._assets import write_llm_dir

    llm = _llm()
    tensors = write_llm_dir(str(tmp_path), llm, torch.float32)
    assert "model.layers.1.mlp.experts.7.down_proj.weight" in tensors
    assert "model.layers.0.mlp.gate_proj.weight" in tensors
    state, cfg = ds.load_hf_checkpoint(str(tmp_path))
    assert cfg == llm.cfg
    want = llm.state_dict()
    assert set(state) == set(want)
    for k, v in want.items():
        assert torch.equal(state[k], v), k


def test_decode_cli_serves_the_pool_from_a_deepseek_config(tmp_path):
    """The decode CLI on an HF DeepSeek-V3 directory: the factory picks the
    decoder from ``config.json``, and the greedy pool (MODE=continuous)
    writes the static greedy decode's predictions."""
    specials = {"<|endoftext|>": 256, "<|im_start|>": 257, "<|im_end|>": 258}
    model = tasu.model_factory(
        TrainConfig(ctc_posterior=True, do_psd=True, seed=3),
        ModelConfig(llm_dim=64, encoder_dim=11, llm_config_overrides=dict(HF, vocab_size=300),
                    encoder_config_overrides=dict(input_size=560)), device="cpu")
    assets = chip_smoke.write_assets(str(tmp_path / "assets"), model, llm_dtype=torch.float32,
                                     specials=specials, utts={"ark": 3, "wav": 1, "flac": 0},
                                     seconds=(0.5, 1.0))
    with open(os.path.join(assets["llm_path"], "config.json")) as f:
        assert json.load(f)["model_type"] == "deepseek_v3"
    preds = {}
    for mode in ("continuous", "plain"):
        args = chip_smoke.serving_args(assets, mode, "unused", 6, llm_dim=64, encoder_dim=11)
        args = [a for a in args if not a.startswith(("decode_log=", "++log_config"))]
        args += ["++train_config.quantization=false", "++train_config.mixed_precision=false",
                 "++train_config.decode_slots=2", "++dataset_config.eval_max_frame_length=300",
                 "++dataset_config.feature_bucket=16", "++dataset_config.token_bucket=8",
                 f"++log_config.log_file={tmp_path}/{mode}.log", f"decode_log={tmp_path}/{mode}/t"]
        assert decode.main(args, device="cpu") == 0
        with open(f"{tmp_path}/{mode}/t_pred") as f:
            preds[mode] = sorted(f.read().splitlines())
    assert len(preds["plain"]) == 4 and preds["continuous"] == preds["plain"]
