"""Training entry point: the published recipes, on one device or a mesh.

Counterpart of ``ps_slm_tpu/cli/finetune.py``.  Takes the JAX CLI's
``++section.key=value`` overrides, so the argv of
``scripts/finetune_text_only.sh`` and ``scripts/finetune_half_audio.sh``
runs as it is:

    python -m ps_slm_tpu_torch.cli.finetune \\
        ++model_config.llm_path=/path/Qwen2.5-1.5B-Instruct \\
        ++model_config.encoder_path=/path/SenseVoiceSmall \\
        ++train_config.ctc_posterior=true ++train_config.gt_emb=true \\
        ++dataset_config.train_scp_file_path=/path/train/ ...

It writes ``resolved_config.json`` into ``output_dir``, loads the HF
tokenizer, the encoder's BPE model, the LLM and the encoder (the
registry's factory), ``am.mvn`` and ``ckpt_path`` (a reference
``pytorch_model.bin``), restores ``resume_from`` (a train-state directory),
then trains (``training/loop.py``) on the train manifest with fresh
prompt draws each epoch (``seed + epoch``) and validates on the dev one.
A checkpoint ``<output_dir>/<tag>/`` holds the whole train state under
``state/`` and the reference-format ``pytorch_model.bin`` without the
frozen modules.  ``main(argv, device="cpu")`` runs the plain versions on
the CPU; the default is the CUDA device.

``use_peft`` trains ``peft_config``'s adapter (LoRA, prefix tuning or
llama-adapter) on the LLM, over its int8 / int4 weights with
``quantization`` (QLoRA); ``peft_ckpt`` loads HF-PEFT adapters before
training.  Its checkpoints keep the LLM in ``pytorch_model.bin`` (LoRA
merged into the dequantized kernels) and write the adapters beside it
under ``adapter/``.

Several processes (one per device) train as one when ``PS_NUM_HOSTS``,
``PS_HOST_ID`` and ``PS_COORDINATOR`` (``host:port``) are set, as for the
JAX CLI (``parallel.mesh.init_distributed``; ``PS_DIST_BACKEND=gloo`` lets
ranks share one card): ``mesh_shape`` lays them out over
``(pipe, data, fsdp, tensor)`` (default: all ``data``; ``pipe`` composes
with the other three, and ``tensor`` with PEFT and quantized LLMs),
``fsdp_min_size`` and ``pp_microbatches`` as in JAX.  Each process reads its block of every
global batch (``GlobalBatcher`` with the batch axes' coordinate as its
host), the train state is written and restored one file a process, and
rank 0 writes the reference export after a gather every process takes
part in, of the submodules the export writes (the JAX CLI gathers every
parameter).  One process trains on its device whatever ``mesh_shape`` says,
as the JAX CLI sets no mesh on one device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys

import torch

from ps_slm_tpu_torch._build import resolve_device


def main(argv=None, *, device="cuda") -> int:
    from ps_slm_tpu_torch.config import RunConfig, parse_cli
    from ps_slm_tpu_torch.parallel import mesh as meshlib

    cfg = parse_cli(argv if argv is not None else sys.argv[1:], RunConfig())
    resolve_device(device)
    world, rank = meshlib.init_distributed(device)
    try:
        return _main(cfg, device, world, rank)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _main(cfg, device, world: int, rank: int) -> int:
    from ps_slm_tpu_torch.config import dump
    from ps_slm_tpu_torch.data.spm import SenseVoiceTokenizer
    from ps_slm_tpu_torch.data.tokenizer import load_tokenizer
    from ps_slm_tpu_torch.ops.fbank import load_cmvn
    from ps_slm_tpu_torch.models.tasu import trainable_mask
    from ps_slm_tpu_torch.parallel import mesh as meshlib
    from ps_slm_tpu_torch.registry import get_dataset_factory, get_model_factory
    from ps_slm_tpu_torch.training import checkpoint as ckpt
    from ps_slm_tpu_torch.training.loop import train
    from ps_slm_tpu_torch.training.step import make_train_step
    from ps_slm_tpu_torch.utils.logging import MetricLogger, log_model_size, setup_logger

    tc, mc, dc, lc = cfg.train_config, cfg.model_config, cfg.dataset_config, cfg.log_config
    dev = resolve_device(device)

    os.makedirs(tc.output_dir, exist_ok=True)
    if rank:
        # the other ranks log beside rank 0's files, not into them
        lc = dataclasses.replace(lc, log_file=lc.log_file and f"{lc.log_file}.rank{rank}")
    logger = setup_logger("finetune", lc.log_file)
    if rank == 0:
        dump(cfg, os.path.join(tc.output_dir, "resolved_config.json"))

    dtype = torch.bfloat16 if tc.mixed_precision else torch.float32
    tokenizer = load_tokenizer(mc.llm_path or None)
    encoder_tokenizer = None
    if mc.encoder_bpe_path or mc.encoder_path:
        try:
            encoder_tokenizer = SenseVoiceTokenizer(mc.encoder_bpe_path or mc.encoder_path)
        except OSError:
            logger.warning("no encoder BPE model found; gt_ids disabled")

    model = get_model_factory(mc.factory)(tc, mc, device=dev, dtype=dtype)
    model.speech_token_id = tokenizer.speech_token_id
    model.pad_token_id = tokenizer.pad_token_id
    if mc.encoder_path:
        cmvn_path = os.path.join(mc.encoder_path, "am.mvn")
        if os.path.exists(cmvn_path):
            model.cmvn = load_cmvn(cmvn_path)
    model.fbank_cfg = dc.fbank
    for name, secs in getattr(model, "load_seconds", {}).items():
        logger.info(f"loaded {name} in {secs:.2f} s")

    if cfg.ckpt_path:
        loaded = ckpt.import_reference_checkpoint(model, cfg.ckpt_path)
        logger.info(f"loaded {len(loaded)} tensors from {cfg.ckpt_path}")
    if cfg.peft_ckpt and tc.use_peft:
        n = len(ckpt.import_peft_adapters(model, cfg.peft_ckpt))
        logger.info(f"loaded {n} adapter tensors from {cfg.peft_ckpt}")

    sharded = world > 1
    if sharded:
        trainable_mask(model, tc)        # the freeze flags before FSDP2 wraps
        mesh = meshlib.build_mesh(tc.mesh_shape, dev.type)
        meshlib.shard_params(model, mesh, tc.mesh_shape, tc.fsdp_min_size, tc.pp_microbatches)
        logger.info(f"rank {rank} of {world} on the mesh {model.mesh.shape}")
    state = make_train_step(model, tc, device=dev)
    log_model_size(logger, model, state.trainable)
    if tc.resume_from:
        ckpt.restore_train_state(tc.resume_from, state)
        logger.info(f"resumed train state from {tc.resume_from} at step {state.step}")

    dataset_factory = get_dataset_factory(dc.factory)
    fixed_bs = tc.batch_size_training if tc.batching_strategy != "dynamic" else None
    # each process reads its block of the global batch: the batch axes'
    # coordinate is its "host" (pipe and tensor ranks read the same rows)
    block = model.mesh.row_block if sharded else None
    num_hosts, host_id = (block.count, block.index) if block else (1, 0)
    shape = model.mesh.shape if sharded else {"data": 1, "fsdp": 1}
    batch_multiple = max(1, shape["data"] * shape["fsdp"] // num_hosts)

    def train_batches(epoch, skip_batches=0):
        return iter(dataset_factory(
            dc, tokenizer, "train", encoder_tokenizer=encoder_tokenizer,
            num_hosts=num_hosts, host_id=host_id,
            fixed_batch_size=fixed_bs, batch_multiple=batch_multiple,
            seed=tc.seed + epoch,  # fresh prompt draws per epoch
            skip_batches=skip_batches,
        ))

    eval_batches = None
    if dc.dev_scp_file_path:
        eval_bs = tc.val_batch_size if tc.batching_strategy != "dynamic" else None

        def eval_batches():
            return iter(dataset_factory(
                dc, tokenizer, "val", encoder_tokenizer=encoder_tokenizer,
                num_hosts=num_hosts, host_id=host_id,
                fixed_batch_size=eval_bs, batch_multiple=batch_multiple,
            ))

    exclude = tuple(name for name, frozen in (
        ("llm", tc.freeze_llm and not tc.use_peft), ("encoder", tc.freeze_encoder),
        ("projector", tc.freeze_projector)) if frozen)

    def checkpoint_fn(state, tag):
        path = os.path.join(tc.output_dir, tag)
        ckpt.save_train_state(os.path.join(path, "state"), state)
        # the whole parameters the export writes, on every process (a
        # collective), rank 0 writes
        with meshlib.gathered(model, exclude) if sharded else contextlib.nullcontext():
            if rank == 0:
                ckpt.export_reference_checkpoint(
                    model, os.path.join(path, "pytorch_model.bin"), exclude=exclude)
                if tc.use_peft:
                    ckpt.export_peft_adapters(model, os.path.join(path, "adapter"))
                logger.info(f"exported the reference checkpoint to {path}")

    metric_logger = MetricLogger(lc) if rank == 0 else None   # global metrics: once
    try:
        state, history = train(
            model, state, tc, lc, train_batches, eval_batches,
            logger=logger, metric_logger=metric_logger, checkpoint_fn=checkpoint_fn,
        )
    finally:
        if metric_logger is not None:
            metric_logger.close()
    logger.info(f"done; history: {history}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
