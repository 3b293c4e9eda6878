"""Batch decode entry point: a manifest of audio files to pred/gt files.

Counterpart of ``ps_slm_tpu/cli/decode.py`` on its static path: read the
test manifest, load and tokenize, batch (dynamic token budget, or
``val_batch_size`` rows with ``batching_strategy`` other than "dynamic"),
ship each batch to the device (int16 waveforms), run the front end, the
encoder, PSD, the projector, the merge and beam-4 (default) or greedy /
sampled decoding there, and write ``<decode_log>_pred`` / ``_gt`` lines
``key\\ttext``.  Score afterwards with:

    python -m ps_slm_tpu_torch.tools.clean_marks <decode_log>_pred
    python -m ps_slm_tpu_torch.tools.clean_marks <decode_log>_gt
    python -m ps_slm_tpu_torch.tools.wer --char=1 -v=1 <gt> <pred>

``python -m ps_slm_tpu_torch.cli.decode ++section.key=value ...`` takes
the JAX CLI's overrides (``scripts/decode.sh``) and runs on the CUDA
device; ``main(argv, device="cpu")`` runs the plain versions on the CPU.
``PS_NUM_HOSTS`` / ``PS_HOST_ID`` split the manifest between processes,
each writing ``<decode_log>.part<id>_pred``.  The slot-pool
(``continuous_batching``) and draft-verified (``speculative_ctc``) modes
raise (ROADMAP.md queue 1, 'Serving').
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ps_slm_tpu_torch._build import resolve_device
from ps_slm_tpu_torch.inference.generate import generate


def main(argv=None, *, device="cuda") -> int:
    from ps_slm_tpu_torch.config import RunConfig, parse_cli
    from ps_slm_tpu_torch.data.spm import SenseVoiceTokenizer
    from ps_slm_tpu_torch.data.tokenizer import load_tokenizer
    from ps_slm_tpu_torch.ops.fbank import load_cmvn
    from ps_slm_tpu_torch.registry import get_dataset_factory, get_model_factory
    from ps_slm_tpu_torch.training import checkpoint as ckpt
    from ps_slm_tpu_torch.utils.logging import setup_logger
    from ps_slm_tpu_torch.utils.profiler import StepTimer

    cfg = parse_cli(argv if argv is not None else sys.argv[1:], RunConfig())
    tc, mc, dc = cfg.train_config, cfg.model_config, cfg.dataset_config
    dc.inference_mode = True
    _validate_decode_mode(tc)
    dev = resolve_device(device)
    logger = setup_logger("decode", cfg.log_config.log_file)

    dtype = torch.bfloat16 if tc.mixed_precision else torch.float32
    tokenizer = load_tokenizer(mc.llm_path or None)
    encoder_tokenizer = None
    if mc.encoder_bpe_path or mc.encoder_path:
        try:
            encoder_tokenizer = SenseVoiceTokenizer(mc.encoder_bpe_path or mc.encoder_path)
        except OSError:   # no BPE model there: gt_ids are left out
            pass

    model = get_model_factory(mc.factory)(tc, mc, device=dev, dtype=dtype)
    vocab = model.llm.cfg.vocab_size
    for what in ("speech_token_id", "pad_token_id", "eos_token_id"):
        if not 0 <= getattr(tokenizer, what) < vocab:
            raise ValueError(
                f"the tokenizer's {what} {getattr(tokenizer, what)} is outside "
                f"the LLM's {vocab} embedding rows"
            )
    model.speech_token_id = tokenizer.speech_token_id
    model.pad_token_id = tokenizer.pad_token_id
    model.fbank_cfg = dc.fbank
    if mc.encoder_path:
        cmvn_path = os.path.join(mc.encoder_path, "am.mvn")
        if os.path.exists(cmvn_path):
            model.cmvn = load_cmvn(cmvn_path)
    for name, secs in getattr(model, "load_seconds", {}).items():
        logger.info(f"loaded {name} in {secs:.2f} s")
    if cfg.ckpt_path:
        loaded = ckpt.import_reference_checkpoint(model, cfg.ckpt_path)
        logger.info(f"loaded {len(loaded)} tensors from {cfg.ckpt_path}")

    num_hosts = int(os.environ.get("PS_NUM_HOSTS", "1"))
    host_id = int(os.environ.get("PS_HOST_ID", "0"))
    batches = get_dataset_factory(dc.factory)(
        dc, tokenizer, "test", encoder_tokenizer=encoder_tokenizer,
        num_hosts=num_hosts, host_id=host_id,
        fixed_batch_size=tc.val_batch_size if tc.batching_strategy != "dynamic" else None,
    )

    decode_log = cfg.decode_log or "decode"
    if num_hosts > 1:
        decode_log = f"{decode_log}.part{host_id}"
    os.makedirs(os.path.dirname(decode_log) or ".", exist_ok=True)
    pred_path, gt_path = decode_log + "_pred", decode_log + "_gt"
    timer = StepTimer(window=None)   # the whole run
    n_tokens = 0
    with open(pred_path, "w") as fpred, open(gt_path, "w") as fgt:
        for batch in batches:
            tbatch = {k: torch.from_numpy(v) for k, v in batch.items()
                      if isinstance(v, np.ndarray)}
            timer.start()
            out = generate(
                model, tbatch, eos_token_id=tokenizer.eos_token_id, device=dev,
                num_beams=tc.num_beams, max_new_tokens=tc.max_new_tokens,
                do_sample=tc.do_sample, min_length=tc.min_length, top_p=tc.top_p,
                temperature=tc.temperature, length_penalty=tc.length_penalty,
                repetition_penalty=tc.repetition_penalty, kv_bits=tc.kv_cache_bits,
            ).cpu().numpy()
            timer.stop(_audio_secs(batch))
            n_tokens += int((out != tokenizer.eos_token_id).sum())
            texts = tokenizer.batch_decode(out)
            for key, target, text, valid in zip(
                batch["keys"], batch["targets"], texts,
                batch.get("batch_valid", [True] * len(texts)),
            ):
                if valid:
                    fpred.write(f"{key}\t{text}\n")
                    fgt.write(f"{key}\t{target}\n")

    rtf_inv = timer.audio_sec_per_sec
    logger.info(
        f"decode done: {pred_path}; {rtf_inv:.1f} audio-s/s "
        f"(RTF {1.0 / rtf_inv if rtf_inv else float('inf'):.4f}), "
        f"{n_tokens / max(timer.seconds, 1e-9):.1f} tokens/s"
    )
    return 0


def _validate_decode_mode(tc) -> None:
    """The static path honours every decode knob; the slot pools and the
    draft-verified path are not ported yet."""
    for knob in ("continuous_batching", "speculative_ctc"):
        if getattr(tc, knob):
            raise NotImplementedError(
                f"{knob} (the serving pools and CTC-draft decoding) is not "
                "ported yet (ROADMAP.md queue 1, 'Serving')"
            )


def _audio_secs(batch) -> float:
    """Seconds of audio in a batch: the waveforms' samples at 16 kHz, or
    60 ms an LFR frame."""
    if "waveform_length" in batch:
        return float(np.sum(batch["waveform_length"])) / 16000.0
    if "input_feature_length" in batch:
        return float(np.sum(batch["input_feature_length"])) * 0.060
    return 0.0


if __name__ == "__main__":
    raise SystemExit(main())
