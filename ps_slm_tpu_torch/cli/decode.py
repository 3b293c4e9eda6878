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
each writing ``<decode_log>.part<id>_pred``.  The serving modes of
``scripts/decode_serving.sh``: ``continuous_batching`` decodes through a
slot pool (greedy, beam with ``num_beams`` > 1, or speculative), one
request at a time, refilled as slots finish; ``speculative_ctc`` verifies
the CTC head's transcript as a draft (static batches, or in every pool
slot with ``continuous_batching``); ``quantization`` (the model factory)
and ``kv_cache_bits=8`` combine with any of them.
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
    if tc.speculative_ctc and encoder_tokenizer is None:
        raise ValueError(
            "speculative_ctc needs the encoder BPE model (model_config.encoder_path) "
            "to decode the CTC draft")
    if tc.continuous_batching:
        return _decode_continuous(model, tc, dc, tokenizer, encoder_tokenizer, num_hosts,
                                  host_id, pred_path, gt_path, logger, dev)

    timer = StepTimer(window=None)   # the whole run
    n_tokens = 0
    with open(pred_path, "w") as fpred, open(gt_path, "w") as fgt:
        for batch in batches:
            tbatch = {k: torch.from_numpy(v) for k, v in batch.items()
                      if isinstance(v, np.ndarray)}
            spec_kwargs = {}
            if tc.speculative_ctc:
                spec_kwargs = _ctc_draft_kwargs(
                    model, {k: v.to(dev) for k, v in tbatch.items()}, encoder_tokenizer,
                    tokenizer, tc.spec_window)
            timer.start()
            out = generate(
                model, tbatch, eos_token_id=tokenizer.eos_token_id, device=dev,
                num_beams=tc.num_beams, max_new_tokens=tc.max_new_tokens,
                do_sample=tc.do_sample, min_length=tc.min_length, top_p=tc.top_p,
                temperature=tc.temperature, length_penalty=tc.length_penalty,
                repetition_penalty=tc.repetition_penalty, kv_bits=tc.kv_cache_bits,
                **spec_kwargs,
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


def _decode_continuous(model, tc, dc, tokenizer, encoder_tokenizer, num_hosts: int,
                       host_id: int, pred_path: str, gt_path: str, logger, dev) -> int:
    """Slot-pool decode: one request per manifest row (this host's rows by
    sample index), refilled as slots finish; the beam pool with
    ``num_beams`` > 1, a CTC-draft window in every slot with
    ``speculative_ctc``."""
    import time

    from ps_slm_tpu_torch.data.dataset import Collator, MultiTaskDataset
    from ps_slm_tpu_torch.inference import ctc_draft, make_pool_decoder

    ds = MultiTaskDataset(dc, tokenizer, "test", encoder_tokenizer=encoder_tokenizer)
    coll = Collator(tokenizer, dc, inference_mode=True)
    targets: dict = {}
    stats = {"audio": 0.0, "n": 0}

    def requests():
        for i, sample in enumerate(ds):
            if i % num_hosts != host_id:
                continue
            batch = {k: torch.from_numpy(v).to(dev) for k, v in coll([sample]).items()
                     if isinstance(v, np.ndarray)}
            targets[sample.key] = sample.target
            stats["audio"] += (len(sample.waveform) / 16000.0 if sample.waveform is not None
                               else sample.est_frames * 0.060)
            stats["n"] += 1
            if tc.speculative_ctc:
                draft = ctc_draft(model, batch, encoder_tokenizer, tokenizer)
                yield sample.key, (batch, draft, len(draft))
            else:
                yield sample.key, batch

    dec = make_pool_decoder(model, tc, dc, eos_token_id=tokenizer.eos_token_id, device=dev)
    n_tokens = 0
    t0 = time.perf_counter()
    with open(pred_path, "w") as fpred, open(gt_path, "w") as fgt:
        for key, toks in dec.run(requests()):
            n_tokens += len(toks)
            fpred.write(f"{key}\t{tokenizer.decode(toks)}\n")
            fgt.write(f"{key}\t{targets.pop(key)}\n")
    dt = time.perf_counter() - t0
    rtf_inv = stats["audio"] / max(dt, 1e-9)
    mode = f"continuous{'+spec' if tc.speculative_ctc else ''} x{tc.decode_slots}"
    logger.info(
        f"decode done ({stats['n']} utts, {mode}): {pred_path}; {rtf_inv:.1f} audio-s/s "
        f"(RTF {1.0 / rtf_inv if rtf_inv else float('inf'):.4f}), "
        f"{n_tokens / max(dt, 1e-9):.1f} tokens/s"
    )
    return 0


def _validate_decode_mode(tc) -> None:
    """The static path honours every decode knob; the slot pools and the
    draft-verified path reject what they would silently ignore."""
    if not (tc.continuous_batching or tc.speculative_ctc):
        return
    from ps_slm_tpu_torch.inference import validate_pool_decode_knobs

    validate_pool_decode_knobs(
        tc, "continuous_batching" if tc.continuous_batching else "speculative_ctc")


def _ctc_draft_kwargs(model, batch, encoder_tokenizer, tokenizer, window: int) -> dict:
    """The batch's CTC transcripts re-tokenized into LLM drafts for
    ``generate``: the width bucketed to a multiple of 64, as the JAX CLI
    buckets it for its jit signature, the padding masked by
    ``draft_lens``."""
    from ps_slm_tpu_torch.inference.generate import ctc_transcript_ids

    drafts = [tokenizer.encode(encoder_tokenizer.decode(r))
              for r in ctc_transcript_ids(model, batch)]
    d = max(max((len(x) for x in drafts), default=1), 1)
    d = -(-d // 64) * 64
    ids = np.zeros((len(drafts), d), np.int64)
    lens = np.zeros((len(drafts),), np.int64)
    for i, x in enumerate(drafts):
        ids[i, :len(x)] = x
        lens[i] = len(x)
    return {"draft_ids": torch.from_numpy(ids), "draft_lens": torch.from_numpy(lens),
            "spec_window": window}


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
