"""PyTorch port: training with PEFT against the JAX package (CPU, fp32,
plain versions of the kernels), on tests/test_torch_peft.py's tiny models.

* A training step with LoRA dropout, the JAX key's masks fed in: loss and
  adapter gradients (fp32 LoRA and QLoRA over int8); with remat the port
  draws the masks once, outside the recomputed blocks; QLoRA over int8
  and int4 moves only the adapters (and the projector).
* The finetune CLI with ``use_peft`` against the JAX loop on the same
  weights (the JAX init handed over as ``ckpt_path`` and ``peft_ckpt``):
  per-step losses, the exported adapters (``adapter/``) and the merged LLM
  in ``pytorch_model.bin``; the exported adapters, imported into the base,
  reproduce the trained model's hidden states.

Tolerances (fp32): losses 1e-5, gradients 1e-4 (they pass back through
the LLM's layers), the CLI's losses 1e-4 and trained weights atol 1e-4
(AdamW's g / (|g| + eps), as tests/test_torch_train.py states).  About 45 s
on one CPU, a third of it the JAX package's first compiles.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from ps_slm_tpu.models import tasu as jtasu
from ps_slm_tpu.training import checkpoint as jckpt
from ps_slm_tpu.training import train_state as jts
from ps_slm_tpu_torch.cli import finetune
from ps_slm_tpu_torch.config import TrainConfig
from ps_slm_tpu_torch.models import lora, tasu
from ps_slm_tpu_torch.training import checkpoint as ckpt
from ps_slm_tpu_torch.training.step import make_train_step
from test_torch_finetune import _args, _metrics, fixtures  # noqa: F401
from test_torch_peft import HALF_AUDIO, LLM_DIM, _batch, _close, _pair

GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


# ----------------------------------------------------------------------------
# training
# ----------------------------------------------------------------------------

def _jax_masks(rng, jm, merged_shape, rate):
    """The JAX forward's LoRA dropout masks (``fold_in(rng, 23)``, split a
    layer, ``fold_in(layer_key, idx)``) as the port's per-layer dicts."""
    cfg = jm.llm_cfg
    b, t, h = merged_shape
    widths = [h, h, h, cfg.num_attention_heads * cfg.head_dim, h, h, cfg.intermediate_size]
    keys = jax.random.split(jax.random.fold_in(rng, 23), cfg.num_hidden_layers)
    return [{name: torch.from_numpy(np.array(jax.random.bernoulli(
                jax.random.fold_in(keys[i], idx), 1.0 - rate, (b, t, widths[idx]))))
             for idx, name in enumerate(lora.LORA_TARGETS)}
            for i in range(cfg.num_hidden_layers)]


@pytest.mark.parametrize("name", ["lora", "qlora8"])
def test_dropout_step_with_jax_masks_equals_jax(name):
    jtc, jm, _, pm = _pair(name, dropout=0.3)
    jb, tb = _batch()
    rng = jax.random.PRNGKey(7)
    train_part, frozen = jts.partition(jm.params, jtasu.trainable_mask(jm, jtc))
    loss_fn = lambda p: jtasu.forward(jm, jts.combine(p, frozen), jb, rng, train=True)[0]  # noqa: E731
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(train_part)
    with torch.no_grad():
        merged_shape = tasu.prepare_merged(pm, tb).embeds.shape   # JAX's, as its parity test holds
    masks = _jax_masks(rng, jm, merged_shape, 0.3)
    tasu.trainable_mask(pm, TrainConfig(**HALF_AUDIO, use_peft=True))
    loss, _ = tasu.forward(pm, tb, train=True, lora_masks=masks)
    loss.backward()
    _close(loss.item(), want_loss)
    jl = want_grads["llm"]["layers"]
    for proj in lora.LORA_TARGETS:
        for leaf in ("lora_a", "lora_b"):
            for i in range(2):
                got = getattr(getattr(pm.llm.layers[i], proj), leaf).grad
                _close(got.numpy(), np.asarray(jl[proj][leaf])[i], GRAD_TOL, f"{proj}.{leaf} {i}")
    # without masks the dropout would draw; eval takes none
    with torch.no_grad():
        off, _ = tasu.forward(pm, tb, train=False)
    want = jax.jit(lambda p: jtasu.forward(jm, p, jb, rng, train=False)[0])(jm.params)
    _close(off.item(), want)


def test_remat_draws_the_masks_once():
    """Masks come from the step's generator outside the recomputed blocks:
    with remat the step equals the one without, bit for bit."""
    grads = []
    for remat in (False, True):
        _, _, tc, pm = _pair("lora", dropout=0.3, remat=remat)
        step = make_train_step(pm, tc, device="cpu")
        _, tb = _batch()
        loss = step(tb)["loss"]
        grads.append([loss] + [p.detach().clone() for n, p in pm.named_parameters()
                               if n.endswith(("lora_a", "lora_b"))])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("name", ["qlora8", "qlora4"])
def test_qlora_moves_only_the_adapters(name):
    _, _, tc, pm = _pair(name, dropout=0.05, lr=1e-2, warmup_steps=1)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    step = make_train_step(pm, tc, device="cpu")
    for seed in (0, 1):
        _, tb = _batch(seed=seed)
        step(tb)
    after = pm.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert moved and all(k.startswith("projector.") or k.endswith(("lora_a", "lora_b"))
                         for k in moved)
    assert {k for k in moved if k.startswith("llm.")} == {
        k for k in before if k.endswith(("lora_a", "lora_b"))}


# ----------------------------------------------------------------------------
# the finetune CLI
# ----------------------------------------------------------------------------

PEFT_ARGS = ["++train_config.use_peft=true", "++train_config.peft_config.r=4",
             "++train_config.peft_config.lora_alpha=8",
             "++train_config.peft_config.lora_dropout=0.0"]


def _jax_peft_train(args, out):
    """The JAX CLI's wiring (cli/finetune.py) with PEFT on one device:
    every checkpoint exports the merged LLM and the adapters.  Returns the
    initial full checkpoint and adapters."""
    from ps_slm_tpu.config import RunConfig, parse_cli
    from ps_slm_tpu.data.tokenizer import load_tokenizer
    from ps_slm_tpu.parallel.mesh import build_mesh
    from ps_slm_tpu.registry import get_dataset_factory
    from ps_slm_tpu.training.loop import train as jax_loop
    from ps_slm_tpu.training.train_state import build_optimizer, create_train_state
    from ps_slm_tpu.utils.logging import MetricLogger

    cfg = parse_cli(args, RunConfig())
    tc, mc, dc, lc = cfg.train_config, cfg.model_config, cfg.dataset_config, cfg.log_config
    os.makedirs(out, exist_ok=True)
    tok = load_tokenizer(None)
    model = jtasu.model_factory(tc, mc, rng=jax.random.PRNGKey(tc.seed))
    model.speech_token_id, model.pad_token_id = tok.speech_token_id, tok.pad_token_id
    model.fbank_cfg = dc.fbank
    jckpt.export_reference_checkpoint(model, f"{out}/init.bin")
    jckpt.export_peft_adapters(model, f"{out}/init_adapter")
    trainable = jtasu.trainable_mask(model, tc)
    tx, _ = build_optimizer(tc, trainable)
    state = create_train_state(model.params, tx, trainable)
    factory = get_dataset_factory(dc.factory)

    def checkpoint_fn(state, tag):
        model.params = state.params
        os.makedirs(f"{out}/{tag}")
        jckpt.export_reference_checkpoint(model, f"{out}/{tag}/pytorch_model.bin",
                                          exclude=("encoder",))
        jckpt.export_peft_adapters(model, f"{out}/{tag}/adapter")

    metrics = MetricLogger(lc)
    try:
        jax_loop(model, state, tx, tc, lc,
                 lambda epoch, skip_batches=0: iter(factory(
                     dc, tok, "train", fixed_batch_size=tc.batch_size_training,
                     seed=tc.seed + epoch, skip_batches=skip_batches)),
                 lambda: iter(factory(dc, tok, "val", fixed_batch_size=tc.val_batch_size)),
                 build_mesh({"data": 1}, devices=[jax.devices()[0]]), trainable=trainable,
                 metric_logger=metrics, checkpoint_fn=checkpoint_fn)
    finally:
        metrics.close()
    return f"{out}/init.bin", f"{out}/init_adapter"


def test_finetune_cli_use_peft_equals_jax(fixtures, tmp_path):  # noqa: F811
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    init, adapter = _jax_peft_train(_args(fixtures, jout) + PEFT_ARGS, jout)
    assert finetune.main(_args(fixtures, pout) + PEFT_ARGS + [
        f"ckpt_path={init}", f"peft_ckpt={adapter}"], device="cpu") == 0
    jtrain, _ = _metrics(jout)
    ptrain, _ = _metrics(pout)
    assert sorted(ptrain) == sorted(jtrain) == [1, 2, 3, 4]
    for s in jtrain:
        _close(ptrain[s], jtrain[s], dict(rtol=1e-4, atol=1e-4), f"step {s}")
    tags = sorted(p for p in os.listdir(pout) if p.startswith("step_"))
    assert tags == sorted(p for p in os.listdir(jout) if p.startswith("step_")) and tags
    for tag in tags:
        want = torch.load(f"{jout}/{tag}/adapter/adapter_model.bin", weights_only=False)
        got = torch.load(f"{pout}/{tag}/adapter/adapter_model.bin", weights_only=True)
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k].numpy(), np.asarray(want[k]), dict(rtol=1e-5, atol=1e-4), k)
        assert (json.loads(open(f"{pout}/{tag}/adapter/adapter_config.json").read())
                == json.loads(open(f"{jout}/{tag}/adapter/adapter_config.json").read()))
        want = torch.load(f"{jout}/{tag}/pytorch_model.bin", weights_only=False)
        got = torch.load(f"{pout}/{tag}/pytorch_model.bin", weights_only=True)
        assert sorted(got) == sorted(want) and any(k.startswith("llm.") for k in got)
        for k in want:
            _close(got[k].numpy(), np.asarray(want[k]), dict(rtol=1e-5, atol=1e-4), k)
    # the exported adapters, imported into the base, reproduce the logits
    cfg_args = _args(fixtures, pout) + PEFT_ARGS
    from ps_slm_tpu_torch.config import RunConfig, parse_cli

    cfg = parse_cli(cfg_args, RunConfig())
    base = tasu.model_factory(cfg.train_config, cfg.model_config, device="cpu")
    ckpt.import_reference_checkpoint(base, init)
    ckpt.import_peft_adapters(base, f"{pout}/{tags[-1]}/adapter")
    trained = tasu.model_factory(cfg.train_config, cfg.model_config, device="cpu")
    trained.load_state_dict(torch.load(f"{pout}/{tags[-1]}/state/{ckpt.TRAIN_STATE_FILE}",
                                       weights_only=True)["model"])
    x = torch.randn(2, 5, LLM_DIM, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(5).expand(2, 5)
    with torch.no_grad():
        _close(base.llm(x, None, pos)[0].numpy(), trained.llm(x, None, pos)[0].numpy())
