"""Streaming serving entry point: JSONL requests in, JSONL results out.

Counterpart of ``ps_slm_tpu/cli/serve.py``.  Reads requests
``{"key": ..., "path": "<wav | ark:offset | flac>"}`` (a manifest row
without its target; ``task`` defaults to ASR) from a file or stdin, decodes
them on the card and writes ``{"key": ..., "text": ...}`` lines in
completion order, as each finishes:

    python -m ps_slm_tpu_torch.cli.serve ++model_config... [requests.jsonl]
    cat requests.jsonl | python -m ps_slm_tpu_torch.cli.serve ++model_config...

The decode knobs are the decode CLI's: ``decode_slots``, ``max_new_tokens``,
``num_beams`` (> 1: the beam pool), ``speculative_ctc`` / ``spec_window``
(the CTC head's transcript as a draft, greedy only), ``quantization`` /
``quant_bits``, ``kv_cache_bits=8``, and ``stream_partials`` (also
``{"key", "partial": true, "text"}`` lines with the whole text decoded so
far at each pool harvest; greedy and speculative pools only).

``serve_route``: ``pool`` serves through the slot pool
(``inference/continuous*.py``), ``static`` through static batches
(``inference/static_serve.py``), ``auto`` (the default) starts on the pool
and re-chooses every ``route_probe`` completions (``inference/routing.py``:
the median completion under ``route_static_below`` tokens favours static,
measured rates decide once both routes have one).  ``stream_partials`` and
``speculative_ctc`` always take the pool.

A reader thread hands the input's lines to the main thread, which yields
``None`` to the decoder while decodes are in flight and no line is ready,
so a slow stdin never stalls admitted requests.  A bad request (malformed
JSON, an unknown task, unreadable audio, a length the filter drops) gets a
``{"key", "error"}`` line and serving goes on.  ``main(argv,
device="cpu")`` runs the plain versions on the CPU; the default is the CUDA
device.
"""

from __future__ import annotations

import json
import os
import queue
import random
import sys
import threading

import numpy as np
import torch

from ps_slm_tpu_torch._build import resolve_device


def _split_argv(argv):
    """(the requests file or None, the config overrides): a positional
    argument is the requests file when it has no '=' or names a file."""
    req_path, rest = None, []
    for a in argv:
        if a.startswith(("+", "-")) or ("=" in a and not os.path.exists(a)):
            rest.append(a)
            continue
        if req_path is not None:
            raise ValueError(f"multiple request files given: {req_path!r} and {a!r}")
        req_path = a
    return req_path, rest


def main(argv=None, *, stdin=None, stdout=None, device="cuda") -> int:
    from ps_slm_tpu_torch.config import RunConfig, parse_cli
    from ps_slm_tpu_torch.data.dataset import Collator, MultiTaskDataset
    from ps_slm_tpu_torch.data.spm import SenseVoiceTokenizer
    from ps_slm_tpu_torch.data.tokenizer import load_tokenizer
    from ps_slm_tpu_torch.inference import (
        ctc_draft, make_pool_decoder, validate_pool_decode_knobs,
    )
    from ps_slm_tpu_torch.inference.routing import route_serve
    from ps_slm_tpu_torch.inference.static_serve import StaticBatchDecoder
    from ps_slm_tpu_torch.ops.fbank import load_cmvn
    from ps_slm_tpu_torch.registry import get_model_factory
    from ps_slm_tpu_torch.training import checkpoint as ckpt
    from ps_slm_tpu_torch.utils.logging import setup_logger

    req_path, rest = _split_argv(list(argv if argv is not None else sys.argv[1:]))
    cfg = parse_cli(rest, RunConfig())
    tc, mc, dc = cfg.train_config, cfg.model_config, cfg.dataset_config
    dc.inference_mode = True
    dev = resolve_device(device)
    logger = setup_logger("serve", cfg.log_config.log_file)
    stdout = stdout or sys.stdout

    dtype = torch.bfloat16 if tc.mixed_precision else torch.float32
    tokenizer = load_tokenizer(mc.llm_path or None)
    encoder_tokenizer = None
    if mc.encoder_bpe_path or mc.encoder_path:
        try:
            encoder_tokenizer = SenseVoiceTokenizer(mc.encoder_bpe_path or mc.encoder_path)
        except OSError:
            pass
    if tc.speculative_ctc and encoder_tokenizer is None:
        raise ValueError("speculative_ctc needs the encoder BPE model (model_config.encoder_path)")
    route = tc.serve_route
    if route not in ("auto", "pool", "static"):
        raise ValueError(f"serve_route must be auto|pool|static, got {route!r}")
    if tc.stream_partials or tc.speculative_ctc:
        route = "pool"
    if route != "static":
        # the pools decode plain greedy / beam only: refuse the knobs they
        # would ignore (the static path honours them)
        validate_pool_decode_knobs(tc, "serve (slot-pool decoding)")

    model = get_model_factory(mc.factory)(tc, mc, device=dev, dtype=dtype)
    model.speech_token_id = tokenizer.speech_token_id
    model.pad_token_id = tokenizer.pad_token_id
    model.fbank_cfg = dc.fbank
    if mc.encoder_path:
        cmvn_path = os.path.join(mc.encoder_path, "am.mvn")
        if os.path.exists(cmvn_path):
            model.cmvn = load_cmvn(cmvn_path)
    if cfg.ckpt_path:
        n = len(ckpt.import_reference_checkpoint(model, cfg.ckpt_path))
        logger.info(f"loaded {n} tensors from {cfg.ckpt_path}")

    coll = Collator(tokenizer, dc, inference_mode=True)
    prompt_rng = random.Random(tc.seed)
    builder = MultiTaskDataset.for_requests(dc, tokenizer, encoder_tokenizer=encoder_tokenizer)
    source = open(req_path) if req_path else (stdin or sys.stdin)

    def emit(obj) -> None:
        stdout.write(json.dumps(obj) + "\n")
        stdout.flush()

    lines: queue.Queue = queue.Queue()
    eof = object()

    def reader():
        try:
            for line in source:
                lines.put(line)
        finally:
            lines.put(eof)

    threading.Thread(target=reader, daemon=True, name="serve-reader").start()
    flow = {"admitted": 0, "emitted": 0}

    def requests():
        i = 0
        while True:
            idle = flow["admitted"] == flow["emitted"]
            try:
                # nothing in flight: wait for a line; else hand back at once
                line = lines.get(block=idle)
            except queue.Empty:
                yield None
                continue
            if line is eof:
                return
            i += 1
            line = line.strip()
            if not line:
                continue
            key = f"<line {i}>"
            try:
                item = json.loads(line)
                key = item.get("key", key)
                item.setdefault("target", "")
                item.setdefault("task", "ASR")
                sample = builder._build(item, prompt_rng, i)
                if sample is None:
                    emit({"key": key, "error": "filtered (length)"})
                    continue
                batch = {k: torch.from_numpy(v).to(dev) for k, v in coll([sample]).items()
                         if isinstance(v, np.ndarray)}
                if tc.speculative_ctc:
                    draft = ctc_draft(model, batch, encoder_tokenizer, tokenizer)
            except Exception as e:  # noqa: BLE001 -- one bad request must not end serving
                logger.warning(f"bad request {key}: {e}")
                emit({"key": key, "error": f"{type(e).__name__}: {e}"})
                continue
            flow["admitted"] += 1
            yield sample.key, ((batch, draft, len(draft)) if tc.speculative_ctc else batch)

    on_partial = None
    if tc.stream_partials:
        # the whole text so far, not a delta: byte-level BPE can split a
        # character across two harvests
        def on_partial(key, prefix):
            emit({"key": key, "partial": True, "text": tokenizer.decode(prefix)})

    def make_static():
        return StaticBatchDecoder(model, tc, dc, eos_token_id=tokenizer.eos_token_id, device=dev)

    def make_pool():
        return make_pool_decoder(model, tc, dc, eos_token_id=tokenizer.eos_token_id, device=dev)

    if route == "static":
        results = make_static().run(requests())
    elif route == "pool":
        results = make_pool().run(requests(), on_partial=on_partial)
    else:
        results = route_serve(requests(), make_pool, make_static, probe=tc.route_probe,
                              static_below=tc.route_static_below, on_partial=on_partial,
                              log=logger.info)
    n = 0
    for key, toks in results:
        emit({"key": key, "text": tokenizer.decode(toks)})
        n += 1
        flow["emitted"] += 1
    if req_path:
        source.close()
    logger.info(f"served {n} requests")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
