"""Training entry point: the published recipes on one device.

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

Not ported, and raising where they would act: a device mesh
(``mesh_shape``) and more than one process (``PS_NUM_HOSTS`` > 1,
``PS_COORDINATOR``), ROADMAP.md queue 1 'Parallelism'.
"""

from __future__ import annotations

import os
import sys

import torch

from ps_slm_tpu_torch._build import resolve_device


def check_ported(tc) -> None:
    """Raise on the options of the JAX CLI whose features are not ported."""
    if (tc.mesh_shape or "PS_COORDINATOR" in os.environ
            or int(os.environ.get("PS_NUM_HOSTS", "1")) > 1):
        raise NotImplementedError(
            "a device mesh and multi-process training (mesh_shape, PS_NUM_HOSTS, "
            "PS_COORDINATOR) are not ported yet (ROADMAP.md queue 1, 'Parallelism')"
        )


def main(argv=None, *, device="cuda") -> int:
    from ps_slm_tpu_torch.config import RunConfig, dump, parse_cli
    from ps_slm_tpu_torch.data.spm import SenseVoiceTokenizer
    from ps_slm_tpu_torch.data.tokenizer import load_tokenizer
    from ps_slm_tpu_torch.ops.fbank import load_cmvn
    from ps_slm_tpu_torch.registry import get_dataset_factory, get_model_factory
    from ps_slm_tpu_torch.training import checkpoint as ckpt
    from ps_slm_tpu_torch.training.loop import train
    from ps_slm_tpu_torch.training.step import make_train_step
    from ps_slm_tpu_torch.utils.logging import MetricLogger, log_model_size, setup_logger

    cfg = parse_cli(argv if argv is not None else sys.argv[1:], RunConfig())
    tc, mc, dc, lc = cfg.train_config, cfg.model_config, cfg.dataset_config, cfg.log_config
    check_ported(tc)
    dev = resolve_device(device)

    os.makedirs(tc.output_dir, exist_ok=True)
    logger = setup_logger("finetune", lc.log_file)
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

    state = make_train_step(model, tc, device=dev)
    log_model_size(logger, model, state.trainable)
    if tc.resume_from:
        ckpt.restore_train_state(tc.resume_from, state)
        logger.info(f"resumed train state from {tc.resume_from} at step {state.step}")

    dataset_factory = get_dataset_factory(dc.factory)
    fixed_bs = tc.batch_size_training if tc.batching_strategy != "dynamic" else None

    def train_batches(epoch, skip_batches=0):
        return iter(dataset_factory(
            dc, tokenizer, "train", encoder_tokenizer=encoder_tokenizer,
            fixed_batch_size=fixed_bs,
            seed=tc.seed + epoch,  # fresh prompt draws per epoch
            skip_batches=skip_batches,
        ))

    eval_batches = None
    if dc.dev_scp_file_path:
        eval_bs = tc.val_batch_size if tc.batching_strategy != "dynamic" else None

        def eval_batches():
            return iter(dataset_factory(
                dc, tokenizer, "val", encoder_tokenizer=encoder_tokenizer,
                fixed_batch_size=eval_bs,
            ))

    exclude = tuple(name for name, frozen in (
        ("llm", tc.freeze_llm and not tc.use_peft), ("encoder", tc.freeze_encoder),
        ("projector", tc.freeze_projector)) if frozen)

    def checkpoint_fn(state, tag):
        path = os.path.join(tc.output_dir, tag)
        ckpt.save_train_state(os.path.join(path, "state"), state)
        ckpt.export_reference_checkpoint(
            model, os.path.join(path, "pytorch_model.bin"), exclude=exclude)
        if tc.use_peft:
            ckpt.export_peft_adapters(model, os.path.join(path, "adapter"))

    metric_logger = MetricLogger(lc)
    try:
        state, history = train(
            model, state, tc, lc, train_batches, eval_batches,
            logger=logger, metric_logger=metric_logger, checkpoint_fn=checkpoint_fn,
        )
    finally:
        metric_logger.close()
    logger.info(f"done; history: {history}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
