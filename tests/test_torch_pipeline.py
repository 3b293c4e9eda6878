"""PyTorch port: GPipe over the LLM's layer stack (``parallel/pipeline.py``).

* ``microbatch_count`` equals the JAX function for every batch, request
  and stage count in a grid.
* Two processes (gloo, CPU) form a ``{"pipe": 2}`` mesh over a 4-layer
  fp32 Qwen2 stack with LoRA on q/v; each stage keeps its two layers and
  frees the other two (their tensors empty).  At M = 1, 2 and 4
  microbatches the pipelined forward, the gradient of its input and the
  LoRA gradients of the stage's own layers equal the unpipelined
  stack's, with remat and without: the outputs and the input gradient
  within 1e-6, the LoRA gradients within 1e-5 of each one's largest
  element (the microbatches' parts sum in another order).  LoRA dropout
  at M = 1 draws the unpipelined step's masks: the outputs agree within
  1e-6 and both generators end in the same state.

CPU time alone: ~15 s (one launch of 2 processes).
"""

import json
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TOL = 1e-6
GRAD_TOL = 1e-5    # of each LoRA gradient's largest element: microbatches sum in another order
MICRO = (1, 2, 4)


@pytest.mark.parametrize("stages", [1, 2, 4])
def test_microbatch_count_equals_jax(stages):
    from ps_slm_tpu.parallel.pipeline import microbatch_count as jax_count
    from ps_slm_tpu_torch.parallel.pipeline import microbatch_count

    for batch in range(1, 33):
        for n_micro in range(0, 12):
            assert microbatch_count(batch, n_micro, stages) == jax_count(batch, n_micro, stages)


def _stack(seed=0):
    from types import SimpleNamespace

    from torch import nn

    from ps_slm_tpu_torch.models.lora import add_lora
    from ps_slm_tpu_torch.models.qwen2 import Qwen2Config, Qwen2Model

    cfg = Qwen2Config.tiny(num_hidden_layers=4)
    llm = Qwen2Model(cfg)
    g = torch.Generator().manual_seed(seed)
    llm.init_weights(g)
    add_lora(llm, SimpleNamespace(r=4, lora_alpha=8, target_modules=["q_proj", "v_proj"]), g)
    with torch.no_grad():
        for layer in llm.layers:
            layer.q_proj.lora_b.normal_(0.0, 0.02, generator=g)
    for n, p in llm.named_parameters():
        p.requires_grad_(n.rpartition(".")[2] in ("lora_a", "lora_b"))
    holder = nn.Module()
    holder.llm = llm          # the TASU model's layout: sync_grads reads llm.layers.*
    return holder, cfg


def _inputs(cfg, b=4, s=7, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, cfg.hidden_size, generator=g)
    mask = torch.ones(b, s, dtype=torch.bool)
    mask[0, -2:] = False
    pos = torch.where(mask, torch.cumsum(mask.long(), 1) - 1, 1)
    return x, pos, mask


def _run(holder, x, pos, mask, generator=None):
    x = x.clone().requires_grad_(True)
    y, _ = holder.llm(x, mask, pos, generator=generator)
    (y * torch.linspace(-1, 1, y.shape[-1])).sum().backward()
    grads = {n: p.grad.clone() for n, p in holder.named_parameters() if p.requires_grad}
    for p in holder.parameters():
        p.grad = None
    return y.detach(), x.grad, grads


def _worker(out_path):
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from ps_slm_tpu_torch.parallel import mesh as meshlib

    world, rank = meshlib.init_distributed("cpu")
    try:
        holder, cfg = _stack()
        x, pos, mask = _inputs(cfg)
        results = {}
        want = {}
        holder.llm.mesh = None
        for remat in (False, True):
            holder.llm.remat = remat
            want[remat] = _run(holder, x, pos, mask)
        g1 = torch.Generator().manual_seed(7)
        holder.llm.lora_dropout, holder.llm.remat = 0.3, False
        want_dropout = _run(holder, x, pos, mask, generator=g1)
        holder.llm.lora_dropout = 0.0
        ctx = meshlib.Parallel(meshlib.build_mesh({"pipe": 2}, "cpu"), {
            "pipe": 2, "data": 1, "fsdp": 1, "tensor": 1})
        meshlib.free_other_stages(holder, ctx)
        own = ctx.held(holder, [n for n, p in holder.named_parameters() if p.requires_grad])
        results["own"] = own
        results["freed_empty"] = all(
            t.numel() == 0 for n, t in holder.state_dict().items() if n in ctx.freed)
        holder.llm.mesh = ctx
        for remat in (False, True):
            holder.llm.remat = remat
            for m in MICRO:
                holder.llm.pp_microbatches = m
                x2 = x.clone().requires_grad_(True)
                y, _ = holder.llm(x2, mask, pos)
                (y * torch.linspace(-1, 1, y.shape[-1])).sum().backward()
                ctx.sync_grads(holder)
                got = (y.detach(), x2.grad,
                       {n: p.grad.clone() for n, p in holder.named_parameters()
                        if p.requires_grad})
                for p in holder.parameters():
                    p.grad = None
                ref = want[remat]
                results[(remat, m)] = [float((a - b).abs().max()) for a, b in (
                    (got[0], ref[0]), (got[1], ref[1]))] + [
                    max(float((got[2][n] - ref[2][n]).abs().max() / ref[2][n].abs().max())
                        for n in own), sorted(got[2]) == sorted(own)]
        # LoRA dropout at M = 1: the unpipelined step's masks
        holder.llm.lora_dropout = 0.3
        holder.llm.remat = False
        holder.llm.pp_microbatches = 1
        g2 = torch.Generator().manual_seed(7)
        y, _ = holder.llm(x, mask, pos, generator=g2)
        results["dropout"] = [float((y.detach() - want_dropout[0]).abs().max()),
                              bool(torch.equal(g1.get_state(), g2.get_state()))]
        torch.save(results, f"{out_path}.rank{rank}")
    finally:
        dist.destroy_process_group()


def test_pipeline_equals_the_unpipelined_stack(tmp_path):
    sys.path.insert(0, ROOT)
    from ps_slm_tpu_torch.parallel.launch import launch

    out = str(tmp_path / "pipe")
    done = launch([sys.executable, __file__, out], 2,
                  env={"PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"}, timeout=180, cwd=ROOT)
    for f in done:
        assert f.returncode == 0, f"rank {f.rank}\n{f.stdout[-2000:]}\n{f.stderr[-4000:]}"
    for rank in range(2):
        res = torch.load(f"{out}.rank{rank}", weights_only=False)
        # the stage trains its own two layers' LoRA factors and holds no copy of the rest
        assert sorted({int(n.split(".")[2]) for n in res["own"]}) == [2 * rank, 2 * rank + 1]
        assert res["freed_empty"]
        for remat in (False, True):
            for m in MICRO:
                out_err, x_err, lora_err, own_grads = res[(remat, m)]
                assert out_err <= TOL and x_err <= TOL and lora_err <= GRAD_TOL and own_grads, (
                    rank, remat, m, json.dumps(res[(remat, m)]))
        assert res["dropout"][0] <= TOL and res["dropout"][1], res["dropout"]


if __name__ == "__main__":
    _worker(sys.argv[1])
