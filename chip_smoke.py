#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ps_slm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --variants   # phases 1-2, then the LayerNorm
                                       # forward's and backward's designs
                                       # side by side
    python3 chip_smoke.py --slice12    # phase 12 alone (and its phase 3 rows)
    python3 chip_smoke.py --slice13    # phase 13 alone (and its phase 3 rows),
                                       # with each launch's wall, its ranks'
                                       # start and import seconds

Phases, each of which fails the run:

1. card: name and power limit from nvidia-smi; TF32 off for comparisons;
2. build: nvcc builds every kernel from ``ps_slm_tpu_torch/csrc`` into
   ``build/ps_slm_tpu_torch/`` (one nvcc per source, in parallel); then,
   for each flash wrapper and dtype, the kernel it launches, its route
   (tensor cores or fp32 FMA), ptxas's registers and spills and the
   tensor-core instructions (HMMA) in its SASS (``cuobjdump``); a
   tensor-core kernel that spills or has no HMMA fails the run; the
   LayerNorm backward's wide kernel's registers and spills; and those of
   every other norm kernel (the LayerNorm forward's, the LayerNorm
   backward's vectorised one and RMSNorm's on every route, each dtype and
   chunks a lane, with and without dw / dw and db, and the partial sum),
   where a spill in a bf16 vectorised kernel fails the run;
3. kernels: each kernel against its plain PyTorch version at the main
   paths' shapes, in fp32 and bf16, with its time, the plain version's,
   one PyTorch library call's, and the least time the card could take:
   the forward kernels at the serving shapes, the backward kernels (flash
   dq/dkv, LayerNorm and RMSNorm backward) at the training shapes, plus
   a ragged flash case with a left-padded row and a row with no valid key
   (its library time from SDPA with a boolean mask of the same windows),
   and dq + dk/dv together against SDPA's whole backward; the RMSNorm
   backward with dw and with frozen weights (the training main path's
   call), each against ``F.rms_norm``'s autograd backward with the weight
   trained or frozen, and the LayerNorm backward likewise (kernel + the
   dw/db sum against ``F.layer_norm``'s backward) on both its routes, the
   encoder training step's 760 x 560 / 512 rows included; the beam
   decode's and the text-only step's shapes
   too (RMSNorm at 16 and 795 rows, flash forward, dq and dk/dv at 5 x
   159, the projector's LayerNorm forward and backward at 640 x 25 055 on
   smoothed, clean and all-zero one-hot rows); the route each norm call
   took, where a main-path shape off its route (MAIN_ROUTES) fails the
   run;
4. serving path, fp32, full width at reduced depth: merged embeddings,
   prefill logits and 8 greedy tokens for the serving batch on the card
   against the same model on the CPU (plain versions);
4b. training path, fp32, full width at reduced depth: two training steps
   of the half_audio recipe on a ragged 5-utterance batch on the card and
   on the CPU: loss, accuracy and token count per step, the projector
   after the second step, the projector moved and the frozen weights
   bit-identical;
4c. beam and text-only paths, fp32, the same model: ``generate`` with the
   default beams (4) and 8 new tokens on the serving batch, equal tokens
   on card and CPU; two text-only training steps (the flags swapped to
   the paper's recipe, insertion on) on a ragged 5-row transcript batch,
   the noise drawn once on the CPU and fed to both, as in 4b;
4d. decode CLI, fp32, full width at reduced depth: the phase 6 assets
   (8 of its 32 utterances) written from a 2+1-block encoder and a
   1-layer LLM, then
   ``cli.decode.main`` with scripts/decode.sh's overrides (beam 4, 8 new
   tokens) on the card and on the CPU; byte-identical ``_pred`` files;
5. serving main path, bf16, full width (SenseVoiceSmall + linear-silu +
   Qwen2.5-1.5B, random weights from a seed): ``generate`` on 4
   utterances, with every kernel's launch count and the decode steps
   counted around the call (every RMSNorm launch on the vectorised
   route; the LayerNorm forward's 142 vectorised and 1 staged); two calls
   with bit-identical tokens; two ``prepare_merged`` calls, which must give bit-identical embeddings;
   the PSD's device time; then ``generate`` again under ``torch.profiler``
   (device activity only) for the device-busy share;
5b. training main path, bf16, the same model, at bench.py's batch (5 x
   512 frames, 32 text tokens): 3 warm-up and 10 timed steps of
   ``make_train_step`` with every kernel's launches per step checked
   exactly, and by route as in phase 5; step ms, audio-sec/s and MFU,
   peak memory; the PSD's device time; one step under ``torch.profiler``;
5c. beam-4 serving main path, bf16, the same model: ``generate`` with the
   JAX default beams on phase 5's batch, exact launches (flash 98,
   LayerNorm 142 vec + 1 staged, RMSNorm 57 x 32 at 16 decode rows), 31
   decode steps counted around ``_step`` (no early exit), two calls with
   bit-identical tokens; wall, first token, ms per beam step,
   audio-sec/s, peak memory, the profiled device-busy share;
5d. text-only training main path, bf16, the same weights with the flags
   of ``text_only_configs()`` (noise on, insertion off): 5 transcripts of
   128/112/96/80/64 CTC ids, 32 text tokens; 3 warm-up and 10 timed steps
   with exact launches per step (flash 28 / 28 / 28, LayerNorm 1 staged +
   1 backward, RMSNorm 57 / 57; the encoder does not run), finite
   losses, frozen weights bit-identical, the projector moved; step ms,
   peak memory, one profiled step;
6. decode CLI, bf16, the published widths and depths: scripts/decode.sh's
   assets as synthetic stand-ins in its layout, written from a seeded model
   into a temporary directory (an HF Qwen2.5 directory with bf16
   safetensors and a byte-level tokenizer with Qwen2.5's special tokens, a
   funasr SenseVoiceSmall directory with an fp32 model.pt and a 560-wide
   am.mvn, the linear-silu projector under reference keys, and a
   multitask.jsonl over 32 utterances of 2-12 s: 24 in a Kaldi wav.ark, 4
   .wav, 4 .flac), then ``cli.decode.main`` with the recipe's overrides
   (beam 4, 32 new tokens instead of 200: random weights never emit EOS),
   then the port's clean_marks and WER.  Checks: every utterance once in
   ``_pred`` and ``_gt``; the loaded tensors bit-equal to the written ones
   cast to bf16; parameters and CMVN on the card; per batch flash 98,
   LayerNorm 142 vec + 1 staged, RMSNorm 57 x 32 vec; the first batch
   re-decoded bit-identical; the fp32 front end within 1e-3 of the CPU's.
   Prints the load seconds, each batch's rows / LFR frames / merged
   length, the CLI's audio-s/s and tokens/s, the share of ``main`` outside
   ``generate``, the front end's and one generate's profiled device time,
   peak memory and the (meaningless) WER; then phase 3's forward kernels
   at its largest batch's shapes;
4e. finetune CLI, fp32, full width at reduced depth (run after 4d): phase
   4d's assets with an 8-utterance train and a 4-utterance dev manifest
   of 2-6 s, ``cli.finetune.main`` with scripts/finetune_half_audio.sh's
   overrides (dither 0, lr 1e-3 from the first step, 4 steps of 2 rows,
   validation every 2) on the card and on the CPU: per-step and eval
   losses and every exported projector within 1e-3, the same step_N
   checkpoints; then a resume on the card from ``step_2/state`` that must
   report 2 skipped batches and reproduce the last two losses bit for bit;
7. the published training chain at the published widths and depths,
   bf16, through ``cli.finetune.main`` on phase 6's kind of assets (a
   character BPE model beside the encoder for the transcripts' CTC ids)
   with train, dev and test manifests of 2-12 s utterances: 7a
   scripts/finetune_text_only.sh's overrides for one epoch, ``last/``;
   7b scripts/finetune_half_audio.sh's from 7a's export, dither on, one
   epoch with validation every 3 steps and step_N checkpoints, then a
   second ``main`` resuming from step_3, which must skip 3 batches and
   reproduce the later losses bit for bit; 7c the same with remat,
   gradient accumulation 2 and SpecAugment, frozen weights bit-identical,
   an AdamW update every 2nd micro-step; 7d ``cli.decode.main`` on 7b's
   export, clean_marks and WER.  Every micro-step's and validation
   batch's launches are checked exactly, by route (remat: flash forward
   126 and RMSNorm forward 113 a step).  Prints for each stage the
   synchronised step wall (median, min-max, and the median of the warm
   micro-steps, whose batch shapes ran before), audio-s/s (none for 7a,
   whose step reads no audio), eval seconds,
   train-state write and restore seconds and bytes, the fast-forward's
   seconds, peak memory with remat off and on, and one profiled loop step
   beside phase 5b's; then phase 3's forward and backward kernels at 7a's
   and 7b's largest batches' shapes (``finetune_cases``), labelled
   ``finetune 7a`` / ``finetune 7b``;
8. the serving recipe, scripts/decode_serving.sh (its argv parsed from
   the script per MODE, ``quantization=true``: int8 weights), run after
   phase 6 on its assets (a BPE model as wide as the CTC head beside the
   encoder, for the drafts): 8b at full size, bf16, 32 new tokens instead
   of 200: MODE=continuous, speculative and plain, plain with a bf16 LLM
   and continuous with ``kv_cache_bits=8``; each utterance once in
   ``_pred`` and ``_gt``, the serving path's kernels on their routes, the
   int8 LLM at most 0.6x the bf16 LLM's bytes; main, load and decode
   seconds, audio-s/s, the CLI's tokens/s, peak memory, weight and KV
   bytes, the speculative forwards, each mode's agreement with plain
   (reported); 8c the greedy and speculative pools driven directly on
   8b's int8 model, 32 requests capped at 4-32 tokens: each answered
   once within its cap, exact launches per chunk and per refill, one
   chunk profiled, an oracle draft through ``generate(draft_ids=...)``
   against plain greedy; 8a fp32 at full width and reduced depth (2+1
   encoder blocks, 1 LLM layer, 4 utterances, 3 slots, 8 new tokens):
   plain, speculative, int4 weights and the int8 KV cache on the card and
   the CPU, byte-identical ``_pred`` files; continuous, both and the
   beam-4 pool on the card only (phase 10a runs the pools card vs CPU
   through the serve CLI); on the card the pool and speculative modes byte-identical
   to plain greedy (the beam pool to static beam-4); then phase 3's
   forward kernels at the pools' shapes, labelled ``serving pool`` (the
   prefill of 8 x 2 000 left-padded, RMSNorm at 8 / 64 / 32 step rows);
10. the streaming server, ``cli.serve.main``, on requests files of
   manifest rows plus a malformed line and an unreadable path: 10b at
   full size, bf16, on phase 8's assets with MODE=continuous's knobs
   (int8, 8 slots, the 2 000-frame bucket), 32 requests, through the
   pool, static batches, ``serve_route=auto`` (probe 8, static below 64)
   and streamed partials down a pipe one request every 100 ms: each
   request answered once, error lines for the bad ones, partials growing
   prefixes, the first streamed line before the last request is written,
   the norms on their routes; serving wall, requests/s, tokens/s, time to
   the first result, auto's decisions and segment rates, peak memory;
   10a fp32 at 8a's depth on card and CPU through every route (pool,
   static, partials, drafts, beam-4 pool): identical lines, and on the
   card the greedy routes' tokens equal plain greedy decode's;
11. PEFT finetuning through ``cli.finetune.main``: 11a fp32 at reduced
   depth on card and CPU, 2 steps each of LoRA, QLoRA over int8, prefix
   tuning and llama-adapter (losses within 1e-3, exported adapters within
   2e-5, AdamW's first moments within 1e-3 of their size, the base
   bit-identical, a ``peft_ckpt`` import reproducing the
   logits); 11b scripts/finetune_half_audio.sh + ``use_peft`` (LoRA r 64,
   dropout 0.05) at full size, bf16, one epoch on phase 7's assets from
   7a's export: 7b's launches a micro-step exactly, 73 859 072 LoRA
   parameters, the base bit-identical, the adapters moved, one step_N
   and last/ (the merged LLM exported in fp32, ~6.2 GB each: the cut),
   micro-step walls, peak memory, the exports' seconds and bytes; then
   QLoRA over int8 for the same epoch without checkpoints (peak memory);
   11c ``cli.serve.main`` on the merged export, 8 requests answered;
12. encoder training and ASR, the projectors and branches (12a fp32 on
   card and CPU; 12b-12d at full size): see their functions;
13. training over several processes sharing the card over gloo: 13a the
   finetune CLI in fp32 at reduced depth on every mesh (PARALLEL_GROUPS,
   pipe with fsdp and tensor and tensor with LoRA included, the tiny
   model alone in 8 processes), 13b phase 7b's recipe at full size on
   data, fsdp and tensor, 13c whisper mel and goldens verify;
9. one JSON line listing every kernel, then the contract line
   ``{"ok": true, "device": {...}}`` last.

The fp32 phases' CPU sides (4-4e, 8a, 10a, 11a, 12a, 13c) run in REFS, a
worker process beside the card's work (4-4e's from the start, the rest
once 13a's ranks are done); phase 3 times each shape once a call.

Cuts to the wall, none of a mesh, variant, resume, check or tolerance
(each phase still checks what it checked):
13a starts one launch of PARALLEL_PROCESSES processes (the host's cores),
not one per process count and kind (21 processes at once, each importing
torch); groups of them take every mesh's full-width and tiny-model runs
in turn, the 8-process mesh all of them at the end (PARALLEL_GROUPS;
fsdp2 and its resume in a group of their own), and its one-process runs
(LoRA's, the tiny model's) run in this process beside the launch; 13a
runs right after phase 3 and 4e's card run, and 4-4d's card sides and
4e's comparison come after it, so their CPU runs go on beside phase 3
and 13a instead of the card waiting for them; 13b runs data2 and fsdp2 at
once in one launch of 4 processes, tensor2 after data2.  Every launch
prints its processes' start and import seconds and each run's wall
(``--slice13`` measures 13a and 13b alone).

Exits non-zero without a result when CUDA is absent or when the
``ps_slm_tpu_torch`` package is not beside this file.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

T_PROCESS = time.time()   # this process's first statement: a rank's start (phase 13)
HERE = os.path.dirname(os.path.abspath(__file__))

LFR_FRAME_SEC = 0.06    # one LFR frame: 6 x 10 ms shift
# the serving batch: 4 utterances of LFR frames, a prompt with the speech
# token at position 3, greedy decoding of MAX_NEW tokens
FRAMES = (512, 400, 300, 256)
TEXT_LEN = 32
MAX_NEW = 32
SPEECH_TOKEN = 151934   # vocab - 2, as bench.py
EOS = 151645            # <|im_end|>
# kernel launches per LLM forward (28 layers x 2 + the final norm) and per
# generate call (70 encoder + 28 prefill flash calls; 142 encoder + 1
# projector LayerNorms)
RMS_PER_FORWARD = 57
FLASH_PER_GENERATE = 98
LN_PER_GENERATE = 143
# the training batch is bench.py's (config.BENCH_*): 5 utterances of 512
# LFR frames, 32 text tokens with the speech token at 3 and the first 8
# labels ignored; 3 warm-up and 10 timed steps
TRAIN_RAGGED_FRAMES = (512, 400, 300, 256, 200)   # the fp32 card-vs-CPU phase
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
# kernel launches per training step: the frozen encoder runs forward only,
# the gathered CE back-propagates through the final norm, the 28 LLM
# layers and the projector's LayerNorm
LAUNCHES_PER_TRAIN_STEP = {
    "flash_attention_fwd": 98, "flash_attention_dq": 28, "flash_attention_dkv": 28,
    "layer_norm_fwd": 143, "layer_norm_bwd": 1, "rms_norm_fwd": 57, "rms_norm_bwd": 57,
}
# text-only TASU (scripts/finetune_text_only.sh): transcripts of these
# lengths in CTC ids, padded to the longest; the encoder does not run, so a
# step launches the LLM's kernels and the projector's LayerNorm only
TEXT_ONLY_GT_LENS = (128, 112, 96, 80, 64)
LAUNCHES_PER_TEXT_ONLY_STEP = {
    "flash_attention_fwd": 28, "flash_attention_dq": 28, "flash_attention_dkv": 28,
    "layer_norm_fwd": 1, "layer_norm_bwd": 1, "rms_norm_fwd": 57, "rms_norm_bwd": 57,
}
# the text-only step's LLM attention: causal GQA over 5 right-padded rows
# of the merged length, each row's valid length before the drop noise
TEXT_ONLY_FLASH = ("text_only", 5, TEXT_LEN + max(TEXT_ONLY_GT_LENS) - 1, 12, 2, True, [0] * 5,
                   [TEXT_LEN + n - 1 for n in TEXT_ONLY_GT_LENS])
FP32_NEW = 8            # new tokens of the fp32 card-vs-CPU decodes
TEXT_ONLY_INSERT = 0.1  # insertion on in the fp32 text-only phase
# the decode CLI (phases 4d and 6): scripts/decode.sh's recipe on a
# manifest of 32 utterances of 2-12 s at 16 kHz, 16-bit (24 in one Kaldi
# wav.ark, 4 .wav and 4 .flac files), beam 4, DECODE_MAX_NEW new tokens
# (random weights never emit EOS and the beam loop has no early exit)
DECODE_FP32_UTTS = {"ark": 6, "wav": 1, "flac": 1}   # phase 4d, whose CPU run is at full width
DECODE_MAX_NEW = 32
FRONTEND_TOL = 1e-3     # the fp32 front end, card vs CPU, on log-mel
# the finetune CLI (phases 4e, 11a and 7): utterances of 2-6 s (4e) and
# 1-2 s (11a; both run on the CPU too, at full width) and 2-12 s (7);
# phase 7's train, dev
# and test manifests; a training step's launches with remat on the LLM
# (each block's forward recomputed: one flash forward and two RMSNorms a
# layer more), and a validation batch's (the forward kernels only)
FINETUNE_SECONDS = (2.0, 6.0)
PEFT_SECONDS = (1.0, 2.0)
CHAIN_UTTS = {"train": {"ark": 42, "wav": 3, "flac": 3}, "dev": {"ark": 8, "wav": 0, "flac": 0},
              "test": {"ark": 6, "wav": 1, "flac": 1}}
CHAIN_VALIDATION = 3
LAUNCHES_PER_REMAT_STEP = dict(LAUNCHES_PER_TRAIN_STEP, flash_attention_fwd=98 + 28,
                               rms_norm_fwd=57 + 56)
LAUNCHES_PER_EVAL_BATCH = dict(LAUNCHES_PER_TRAIN_STEP, flash_attention_dq=0,
                               flash_attention_dkv=0, layer_norm_bwd=0, rms_norm_bwd=0)

# H100 SXM published peaks (NVIDIA H100 datasheet): memory and the
# rate for the inputs' type (bf16 tensor cores; fp32 outside them)
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

# the kernel each flash wrapper launches for each dtype (the dtype alone
# decides), by the part of its mangled name that tells it apart, and its
# route; the dk/dv tensor-core kernel's partial sums are added by
# dkv_reduce_kernel
FLASH_PATHS = {
    "flash_attention_fwd": (("bf16", "flash_fwd_bf16_kernel", "tensor cores"),
                            ("f32", "flash_fwd_f32_kernel", "fp32 FMA")),
    "flash_attention_dq": (("bf16", "flash_dq_bf16_kernel", "tensor cores"),
                           ("f32", "flash_dq_kernelIf", "fp32 FMA")),
    "flash_attention_dkv": (("bf16", "flash_dkv_bf16_kernel", "tensor cores"),
                            ("bf16", "dkv_reduce_kernel", "sum of the partials"),
                            ("f32", "flash_dkv_f32_kernel", "fp32 FMA")),
}

# the norm kernels in ptxas's report (the LayerNorm backward's apart), by
# mangled name: the kernel, its element type, its integer template argument
# (16-byte chunks a lane on the vectorised route) and its flag (LayerNorm
# for the vectorised forward, dw for the RMSNorm backward, dw/db for the
# LayerNorm's vectorised backward)
NORM_KERNEL = re.compile(r"\d((?:layer_norm_fwd|rms_norm_(?:fwd|bwd))(?:_vec|_held|_staged)?_kernel"
                         r"|layer_norm_bwd_vec_kernel|norm_fwd_vec_kernel|partial_sum_kernel)"
                         r"I(13__nv_bfloat16|f)(?:Li(\d+)E)?(?:Lb([01])E)?")
# the vectorised kernels, where a bf16 spill fails the run
VEC_KERNELS = ("norm_fwd_vec_kernel", "rms_norm_bwd_vec_kernel", "layer_norm_bwd_vec_kernel")
# the route each main-path shape ([rows, d], bf16) must take; the RMSNorm
# wrappers' every main-path launch is vectorised, the LayerNorm forward's
# are the encoder's on the vectorised route and the projector's on the
# staged one, per generate and per training step; the LayerNorm
# backward's the projector's on the wide route, the encoder's (12b) and
# the q-former's (12d) on the vectorised one
MAIN_ROUTES = {
    "rms_norm_fwd": {(2172, 1536): "vec", (4, 1536): "vec", (16, 1536): "vec",
                     (795, 1536): "vec"},
    "rms_norm_bwd": {(2715, 1536): "vec", (795, 1536): "vec"},
    "layer_norm_fwd": {(2064, 512): "vec", (2064, 560): "vec", (2064, 25055): "staged",
                       (640, 25055): "staged"},
    "layer_norm_bwd": {(2560, 25055): "wide", (640, 25055): "wide", (760, 560): "vec",
                       (760, 512): "vec", (256, 768): "vec", (256, 1536): "vec"},
}
LN_ROUTES_PER_PASS = {"vec": LN_PER_GENERATE - 1, "staged": 1, "held": 0, "general": 0}
LN_ROUTES_TEXT_ONLY = {"vec": 0, "staged": 1, "held": 0, "general": 0}

# phase 13: the meshes that run in 2 (4) processes sharing the card over
# gloo (every gloo collective the port calls takes CUDA tensors: all_reduce,
# broadcast, all_gather_into_tensor, reduce_scatter_tensor; DTensor's own
# full_tensor, a functional all_gather, crashes on gloo's CUDA path, so the
# port gathers with all_gather_into_tensor, and gloo's send / recv take no
# CUDA tensor, so the pipeline's sends go through the host under gloo;
# every mesh runs, so none is left to run at size 1), 13b's meshes at full
# size, 13b's train manifest and the fp32 tolerances against one process
# 13a's runs, in one launch of PARALLEL_PROCESSES processes (as many as
# the card's host has cores): groups of launch processes, each taking its
# runs in turn: ("full", mesh, variant) the full-width run
# (PARALLEL_VARIANTS' overrides; "": 4e's recipe), PARALLEL_RESUME's
# resume after it; ("tiny", mesh, variant) the tiny model's run and its
# resume.  Every mesh runs both but pipe2+data2+fsdp2 (8 processes), the
# tiny model's alone, which starts once every process is done with its
# group's runs.  fsdp2, whose every pass gathers the model over gloo, and
# its full-width resume have processes of their own; pipe2+fsdp2 runs last
# in its group, after fsdp2's gathers are done.
PARALLEL_PROCESSES = 8
PARALLEL_GROUPS = (
    ((0, 1, 2, 3), (("full", {"pipe": 2, "data": 2}, ""), ("full", {"pipe": 2, "tensor": 2}, ""),
                    ("full", {"pipe": 2, "fsdp": 2}, ""), ("tiny", {"pipe": 2, "data": 2}, ""),
                    ("tiny", {"pipe": 2, "fsdp": 2}, ""), ("tiny", {"pipe": 2, "tensor": 2}, ""))),
    ((4, 5), (("full", {"fsdp": 2}, ""), ("tiny", {"fsdp": 2}, ""))),
    ((6, 7), (("full", {"data": 2}, ""), ("full", {"pipe": 2}, ""), ("full", {"tensor": 2}, ""),
              ("full", {"tensor": 2}, "lora"), ("tiny", {"data": 2}, ""), ("tiny", {"pipe": 2}, ""),
              ("tiny", {"tensor": 2}, ""), ("tiny", {"tensor": 2}, "lora"))),
    (tuple(range(8)), (("tiny", {"pipe": 2, "data": 2, "fsdp": 2}, ""),)),
)
PARALLEL_VARIANTS = {"": [], "lora": ["++train_config.use_peft=true"]}
PARALLEL_RESUME = {"fsdp": 2}
# 13b's meshes and train manifests: 16 utterances (two micro-steps) on data,
# 8 (one) on fsdp, whose every micro-step gathers the bf16 model over gloo,
# and 8 (one) on tensor; each with the launch processes that run it: data2
# then tensor2 on two, fsdp2 beside them on two more (the four ranks of
# data2 and fsdp2 peak at 45.6 GB together)
PARALLEL_MESHES_BF16 = (({"data": 2}, {"ark": 12, "wav": 2, "flac": 2}, (0, 1)),
                        ({"fsdp": 2}, {"ark": 8, "wav": 0, "flac": 0}, (2, 3)),
                        ({"tensor": 2}, {"ark": 8, "wav": 0, "flac": 0}, (0, 1)))
PARALLEL_TOL = 1e-5
# AdamW's first moments after micro-step MOMENT_STEP, several processes
# against one, of each trained tensor's largest.  The first step runs at
# the warm-up's lr 0, so both gradients in them are taken at the initial
# weights.  The weights alone would pass a gradient scaled by a constant
# (a sum divided twice): AdamW's m / (sqrt(v) + eps) does not change
PARALLEL_MOMENT_TOL = 1e-5
MOMENT_STEP = 2
# the trained projector (4 AdamW steps at lr 1e-3) is held to
# PARALLEL_TOL on every element whose one-process moment is at least
# GRAD_FLOOR of its tensor's largest; the elements below it to a tenth of
# one step.  The ranks' GEMMs have other row counts than one process's, so
# cuBLAS sums in another order, and AdamW's g / (sqrt(v) + eps) scales
# that rounding up where |g| is small (on the H100: data2 3.9e-6 above the
# floor, 1.5e-5 below it, the moments 5.8e-6 and the losses 2.9e-6 apart)
PARALLEL_PROJ_TOL = 1e-4
# a launch's time limit; its processes print every thread's stack 20 s before it
PARALLEL_TIMEOUT = 420.0
WHISPER_TOL = 1e-4      # whisper_log_mel card vs CPU, after the (x + 4) / 4 scaling
# kernel vs plain version on the card: |a - b| <= atol + rtol * |b|
KERNEL_TOL = {"f32": (2e-5, 2e-5), "bf16": (1e-2, 1e-2)}
# fp32 whole path, card vs CPU (matmul and reduction order differ)
PATH_TOL = 1e-3
# the fp32 card-vs-CPU phases' depth: full widths, 2+1 encoder blocks, one
# LLM layer; two where state is kept a layer (4c's beam KV cache, 8a's
# int8 KV slots and pools, 10a's serve routes, 11a's per-layer adapters
# and LoRA masks), so an index past 0 runs, and in 4e, which 13a's pipe=2
# splits
FP32_DEPTH = (dict(num_blocks=2, tp_blocks=1), dict(num_hidden_layers=1))
FP32_DEPTH_LAYERED = (dict(num_blocks=2, tp_blocks=1), dict(num_hidden_layers=2))
# 11a, card vs CPU: the exported adapters (one AdamW step at lr 1e-3 moves
# an element by about 1e-3, so this is 2% of a step) and AdamW's first
# moments (the gradients' average: each tensor's gap over its own largest
# magnitude), which a gradient of the right sign but wrong size fails
ADAPTER_TOL = 2e-5
MOMENT_TOL = 1e-3
PSD_CALLS = 3   # PSD calls a profiled run
CARD = "card not read"   # nvidia-smi's name and power limit, set by main()
PHASE_SECONDS: dict = {}   # each phase's wall seconds, filled by timed()
REFS = None   # the fp32 phases' CPU references' worker process, started by main()
# phase 3's times by kernel, shape and dtype: a shape timed once in a call
# is not timed again (its inputs are still drawn and checked anew)
TIMES: dict = {}


# ----------------------------------------------------------------------------
# the decode CLI's assets: scripts/decode.sh's layout, synthetic stand-ins
# ----------------------------------------------------------------------------

from ps_slm_tpu_torch.tools._assets import (  # noqa: E402  (the writers live in the package)
    DECODE_SECONDS, DECODE_UTTS, write_assets, write_encoder_dir, write_llm_dir, write_manifest,
)


def decode_args(assets: dict, decode_log: str, max_new: int, llm_dim: int = 1536,
                encoder_dim: int = 25055) -> list:
    """scripts/decode.sh's overrides on ``assets`` (max_new_tokens
    ``max_new`` instead of 200), the prompts of ``conf/multiprompt.jsonl``;
    the CLI's log beside ``decode_log``."""
    return [
        f"++model_config.llm_path={assets['llm_path']}",
        f"++model_config.llm_dim={llm_dim}",
        f"++model_config.encoder_path={assets['encoder_path']}",
        f"++model_config.encoder_dim={encoder_dim}",
        "++model_config.encoder_projector=linear-silu",
        "++train_config.ctc_posterior=true",
        "++train_config.do_psd=true",
        "++train_config.num_beams=4",
        f"++train_config.max_new_tokens={max_new}",
        f"++dataset_config.multitask_prompt_path={os.path.join(HERE, 'conf', 'multiprompt.jsonl')}",
        f"++dataset_config.test_scp_file_path={assets['data']}/",
        f"ckpt_path={assets['ckpt_path']}",
        f"decode_log={decode_log}",
        f"++log_config.log_file={decode_log}.log",
    ]


def recipe_args(name: str, env: dict, cli: str = "finetune") -> list:
    """The overrides that ``scripts/<name>.sh`` passes to the ``cli`` CLI
    (finetune or decode), with its shell variables (``LLM``, ``ENCODER``,
    ``DATA``, ``OUT``, ``INIT``, ``CKPT``, ``LOG``) taken from ``env``; with
    ``MODE`` in ``env`` (``scripts/decode_serving.sh``), ``EXTRA`` is what
    the script's ``case`` sets for that mode."""
    import shlex

    with open(os.path.join(HERE, "scripts", f"{name}.sh")) as f:
        text = f.read().replace("\\\n", " ")
    env = dict(env)
    if "MODE" in env:
        modes = dict(re.findall(r'^\s*(\w+)\)\s*\n\s*EXTRA="([^"]*)"', text, re.M))
        env["EXTRA"] = modes[env["MODE"]]
    line = next(ln for ln in text.splitlines() if f".cli.{cli}" in ln)
    words = shlex.split(re.sub(r"\$(\w+)", lambda m: env[m.group(1)], line.replace('"$@"', "")))
    start = next(i for i, w in enumerate(words) if w.endswith(f".cli.{cli}")) + 1
    return words[start:]


def serving_args(assets: dict, mode: str, decode_log: str, max_new: int, llm_dim: int = 1536,
                 encoder_dim: int = 25055) -> list:
    """``scripts/decode_serving.sh``'s overrides in ``MODE=mode`` on
    ``assets`` (max_new_tokens ``max_new`` instead of 200, the widths
    given), the CLI's log beside ``decode_log``."""
    env = {"LLM": assets["llm_path"], "ENCODER": assets["encoder_path"],
           "DATA": os.path.dirname(assets["data"]), "CKPT": assets["ckpt_path"],
           "LOG": decode_log, "MODE": mode}
    return recipe_args("decode_serving", env, cli="decode") + [
        f"++model_config.llm_dim={llm_dim}", f"++model_config.encoder_dim={encoder_dim}",
        f"++train_config.max_new_tokens={max_new}",
        f"++dataset_config.multitask_prompt_path={os.path.join(HERE, 'conf', 'multiprompt.jsonl')}",
        f"++log_config.log_file={decode_log}.log"]


def finetune_args(assets: dict, data_root: str, output_dir: str, *, text_only: bool = False,
                  llm_dim: int = 1536, encoder_dim: int = 25055) -> list:
    """``scripts/finetune_half_audio.sh``'s overrides (``text_only``:
    ``finetune_text_only.sh``'s) on ``assets``, with ``data_root/train/``
    and ``data_root/dev/`` manifests, ``INIT`` the assets' projector
    checkpoint, the widths given and the log in ``output_dir``."""
    env = {"LLM": assets["llm_path"], "ENCODER": assets["encoder_path"], "DATA": data_root,
           "OUT": output_dir, "INIT": assets["ckpt_path"]}
    args = recipe_args("finetune_text_only" if text_only else "finetune_half_audio", env)
    return args + [f"++model_config.llm_dim={llm_dim}", f"++model_config.encoder_dim={encoder_dim}",
                   f"++dataset_config.multitask_prompt_path="
                   f"{os.path.join(HERE, 'conf', 'multiprompt.jsonl')}",
                   f"++log_config.log_file={output_dir}/train.log"]


def tiny_finetune_args(data_root: str, output_dir: str, mesh: dict = None,
                       resume: str = None) -> list:
    """The finetune CLI on a tiny random model (linear-silu; an encoder of
    2+1 blocks 256 wide over 560-wide input with 600 CTC ids, an LLM of 2
    layers 256 wide, both at head dim 128, the flash kernel's) over
    ``data_root``'s train and dev manifests, the half_audio flags, fp32,
    batches of 2, validation and a checkpoint every 2 steps; on ``mesh``
    (every leaf big enough to shard), resumed from ``resume``."""
    enc = dict(input_size=560, output_size=256, attention_heads=2, linear_units=512,
               num_blocks=2, tp_blocks=1, vocab_size=600)
    llm = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=128)
    args = ["++model_config.llm_path=", "++model_config.encoder_projector=linear-silu",
            "++model_config.encoder_dim=600", "++model_config.llm_dim=256",
            "++model_config.encoder_config_overrides=" + json.dumps(enc),
            "++model_config.llm_config_overrides=" + json.dumps(llm),
            "++train_config.ctc_posterior=true", "++train_config.do_psd=true",
            "++train_config.freeze_llm=true", "++train_config.freeze_encoder=true",
            "++train_config.mixed_precision=false", "++train_config.batching_strategy=padding",
            "++train_config.batch_size_training=2", "++train_config.val_batch_size=4",
            "++train_config.num_epochs=1", "++train_config.validation_interval=2",
            "++train_config.lr=1e-2", "++train_config.warmup_steps=1",
            "++train_config.total_steps=20", "++train_config.save_model=true",
            "++train_config.fsdp_min_size=1", f"++train_config.output_dir={output_dir}",
            "++dataset_config.fbank.dither=0.0",
            f"++dataset_config.multitask_prompt_path={os.path.join(HERE, 'conf', 'multiprompt.jsonl')}",
            f"++dataset_config.train_scp_file_path={data_root}/train",
            f"++dataset_config.dev_scp_file_path={data_root}/dev",
            f"++log_config.log_file={output_dir}/train.log", "++log_config.log_interval=1"]
    if mesh is not None:
        args += ["++train_config.mesh_shape=" + json.dumps(mesh)]
    if resume:
        args += [f"++train_config.resume_from={resume}"]
    return args


def state_bytes(torch, path: str) -> int:
    """The bytes of the tensors of a train-state file's model, AdamW state
    and accumulation (a tensor another rank's file holds counts 0)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    accum = blob["train"]["accum"]
    acc = accum["acc"] or []
    tensors = (list(blob["model"].values()) + list(acc.values() if isinstance(acc, dict) else acc)
               + [v for st in accum["optimizer"]["state"].values() for v in st.values()])
    return sum(t.numel() * t.element_size() for t in tensors
               if torch.is_tensor(t) and t.dim() > 0)


def write_bpe_model(encoder_path: str, vocab: int = 0) -> None:
    """A character-level SentencePiece BPE model beside the encoder (the
    name funasr's SenseVoiceSmall uses), covering the manifest's words, so
    the dataset tokenizes transcripts into CTC ids (``gt_ids``); with
    ``vocab``, filled up to that many pieces (``\u2581<i>``), so every id
    of a CTC head that wide decodes (the speculative drafts)."""
    from ps_slm_tpu_torch.data import spm

    pieces = [("<blank>", 0.0, spm.TYPE_CONTROL), ("<unk>", 0.0, spm.TYPE_UNKNOWN),
              ("</s>", 0.0, spm.TYPE_CONTROL)]
    pieces += [(c, -1.0, spm.TYPE_NORMAL) for c in "\u2581abcdefghijklmnopqrstuvwxyz"]
    pieces += [(f"\u2581{i}", -2.0, spm.TYPE_NORMAL) for i in range(vocab - len(pieces))]
    with open(os.path.join(encoder_path, "chn_jpn_yue_eng_ko_spectok.bpe.model"), "wb") as f:
        f.write(spm.serialize_model_proto(pieces))


def posterior_rows(torch, dev, dtype, kind: str, n: int, d: int):
    """[n, d] rows the projector's LayerNorm sees in text-only TASU
    (TEXT_ONLY_GT_LENS padded to 128 frames, repeated for more than 640
    rows): ``clean`` one-hots (generate),
    or ``mixed``: each transcript's smoothed one-hots ((1 - a) onehot +
    a / d, a in [0, 0.1)) followed by all-zero rows (pad frames, inactive
    insertions)."""
    g = torch.Generator(device=dev).manual_seed(n)
    onehot = torch.nn.functional.one_hot(
        torch.randint(0, d, (n,), device=dev, generator=g), d).float()
    if kind == "clean":
        return onehot.to(dtype)
    alpha = 0.1 * torch.rand(n, 1, device=dev, generator=g)
    n_max = max(TEXT_ONLY_GT_LENS)
    row = torch.arange(n, device=dev)
    lens = torch.tensor(TEXT_ONLY_GT_LENS, device=dev)
    valid = (row % n_max) < lens[(row // n_max) % len(TEXT_ONLY_GT_LENS)]
    return (((1 - alpha) * onehot + alpha / d) * valid[:, None]).to(dtype)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def train_batch(torch, input_size: int, frames, seed: int = 0) -> dict:
    """bench.py's training batch for ``frames``: from numpy with ``seed``,
    ids in [1, 1000) with the speech token at 3, labels = ids with the
    first 8 ignored, normal LFR features padded to the longest row; on the
    CPU.  With 5 x 512 frames and seed 0 it is bench.py's batch."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b, a = len(frames), max(frames)
    ids = rng.integers(1, 1000, size=(b, TEXT_LEN))
    ids[:, 3] = SPEECH_TOKEN
    labels = ids.copy()
    labels[:, :8] = -100
    feats = rng.normal(size=(b, a, input_size)).astype(np.float32)
    return {
        "input_ids": torch.from_numpy(ids),
        "attention_mask": torch.ones(b, TEXT_LEN, dtype=torch.bool),
        "labels": torch.from_numpy(labels),
        "input_features": torch.from_numpy(feats),
        "input_feature_length": torch.tensor(list(frames)),
    }


def serving_batch(torch, input_size: int, seed: int = 2) -> dict:
    """:func:`train_batch` for the serving batch's FRAMES, without labels."""
    batch = train_batch(torch, input_size, FRAMES, seed)
    del batch["labels"]
    return batch


def gt_batch(torch, vocab: int, seed: int = 0) -> dict:
    """A text-only training batch: :func:`train_batch`'s 32 text tokens
    and labels, and TEXT_ONLY_GT_LENS transcripts of CTC ids in [1, vocab)
    padded to the longest; from numpy with ``seed``, on the CPU."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b, n = len(TEXT_ONLY_GT_LENS), max(TEXT_ONLY_GT_LENS)
    ids = rng.integers(1, 1000, size=(b, TEXT_LEN))
    ids[:, 3] = SPEECH_TOKEN
    labels = ids.copy()
    labels[:, :8] = -100
    return {
        "input_ids": torch.from_numpy(ids),
        "attention_mask": torch.ones(b, TEXT_LEN, dtype=torch.bool),
        "labels": torch.from_numpy(labels),
        "gt_ids": torch.from_numpy(rng.integers(1, vocab, size=(b, n))),
        "gt_lens": torch.tensor(TEXT_ONLY_GT_LENS),
    }


@contextlib.contextmanager
def counting_steps():
    """Record the host time at which each decode step of ``greedy_generate``
    or ``beam_generate`` starts, by wrapping their ``_step``: the decode
    steps are counted without the kernels' launch counters."""
    from ps_slm_tpu_torch.inference import generate as gen

    real = gen._step
    starts: list = []

    def step(*args, **kwargs):
        starts.append(time.perf_counter())
        return real(*args, **kwargs)

    gen._step = step
    try:
        yield starts
    finally:
        gen._step = real


def loop_steps(tokens, max_new: int) -> int:
    """Decode steps the greedy loop must take for these output tokens: one
    per column after the first, until every row has emitted EOS."""
    ends = [int((row == EOS).nonzero()[0]) if bool((row == EOS).any()) else max_new
            for row in tokens]
    return min(max_new - 1, max(ends))


def real_tokens(tokens, steps: int) -> int:
    """Tokens the rows really generated: up to and including each row's
    first EOS, leaving out the EOS filler of rows that had finished."""
    return sum(int((row == EOS).nonzero()[0]) + 1 if bool((row == EOS).any()) else steps + 1
               for row in tokens)


def mfu(flops: float, ms: float, dev) -> str:
    """``flops`` a step of ``ms`` over the card's dense bf16 peak
    (utils/flops.py::device_peak_tflops), with that peak."""
    from ps_slm_tpu_torch.utils.flops import device_peak_tflops

    peak = device_peak_tflops(dev)
    if peak is None:
        return "MFU not measured (the card is not in the peak table)"
    return f"MFU {flops / (ms / 1e3) / (peak * 1e12):.4f} (bf16 dense peak {peak:.0f} TFLOP/s)"


def profiled(torch, fn, kernels=()):
    """Run ``fn`` once under ``torch.profiler`` with device activity only
    (no host operators are recorded, which keeps the host slow-down small).
    Returns the run's own wall ms, its device-busy ms (the kernels', copies'
    and memsets' durations, summed; one stream, so they do not overlap;
    None when the profiler saw no device activity), the number of device
    operations and the largest items by device time, followed by every
    other item whose name holds one of ``kernels``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            agg = by_name.setdefault(e.name, [0.0, 0])
            agg[0] += e.time_range.elapsed_us() / 1e3
            agg[1] += 1
    busy_ms = sum(v[0] for v in by_name.values()) if by_name else None
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    top = ranked[:10] + [kv for kv in ranked[10:] if any(k in kv[0] for k in kernels)]
    return wall_ms, busy_ms, sum(v[1] for v in by_name.values()), \
        [[name[:60], ms, n] for name, (ms, n) in top]


def print_profiled(label: str, result) -> None:
    wall, busy, ops, top = result
    share = "not measured" if busy is None else f"{busy / wall:.3f}"
    busy_s = "not measured" if busy is None else f"{busy:.2f} ms"
    print(f"profiled {label}: wall {wall:.1f} ms, device-busy {busy_s}, busy share "
          f"{share}, {ops} device ops [{CARD}]; largest {json.dumps(top)}", flush=True)


def time_ms(torch, fn, iters: int = 20) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph,
    replayed between two events, so the host's launch cost (which bounds
    back-to-back eager calls of a small kernel) is left out.  Inputs stay
    in L2 between the calls when they fit in it (50 MB)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def timed_once(key: tuple, measure):
    """``measure()``'s times for the case ``key`` (kernel, shape, dtype),
    measured the first time a call meets it and kept in TIMES."""
    if key not in TIMES:
        TIMES[key] = measure()
    return TIMES[key]


def eager_ms(torch, fn, iters: int = 200) -> float:
    """Time of one call issued back to back from Python: for a small
    kernel this is the host's cost of the call, not the device's (200
    calls, since the host's speed varies from call to call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def backward_ms(torch, fwd, inputs, grad_out):
    """Device ms of the autograd backward of one PyTorch call: forward and
    backward captured together in a CUDA graph, less the forward alone.
    Returns (ms, method); where autograd cannot be captured, the backward
    alone is timed with events around eager calls (host cost included)."""
    def both():
        torch.autograd.grad(fwd(), inputs, grad_out)

    try:
        with torch.no_grad():
            fwd_ms = time_ms(torch, fwd)
        return time_ms(torch, both) - fwd_ms, "graph (forward+backward) - graph (forward)"
    except RuntimeError as e:
        print(f"backward_ms: capture failed ({str(e)[:80]}); timing eager calls", flush=True)
        out = fwd()
        return eager_ms(torch, lambda: torch.autograd.grad(
            out, inputs, grad_out, retain_graph=True)), "events around eager backward calls"


def bound(bytes_moved: float, flops: float, dt: str):
    t_bytes = bytes_moved / MEM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, got, want, dt: str, what: str, scale: float = 1.0) -> float:
    """Max abs error of a kernel's output against its plain version; fails
    beyond ``KERNEL_TOL[dt]``, its atol times ``scale`` (weight gradients,
    summed over n rows, take sqrt(n)), or on any NaN."""
    atol, rtol = KERNEL_TOL[dt]
    atol *= scale
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    if torch.isnan(got).any() or not bool(((got - want).abs() <= atol + rtol * want.abs()).all()):
        fail(f"{what}: kernel disagrees with its plain version (max abs err {err})")
    return err


def ptxas_report(logs: dict) -> dict:
    """{mangled kernel name: [registers, spill bytes stored + loaded]} from
    the nvcc logs of ``_build.build_all`` (``-Xptxas -v``)."""
    report, fn = {}, None
    for line in "\n".join(logs.values()).splitlines():
        words = line.split()
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            report[fn] = [None, None]
        elif fn and "spill stores" in line:       # stack, stores, loads
            nums = [int(w) for w in words if w.isdigit()]
            report[fn][1] = nums[1] + nums[2]
        elif fn and "Used" in words and "registers," in words:
            report[fn][0] = int(words[words.index("Used") + 1])
    return report


def sass_hmma(lib_paths) -> dict:
    """{mangled kernel name: tensor-core (HMMA) instructions in its SASS}
    over the libraries, from ``cuobjdump -sass``; None without cuobjdump."""
    import shutil

    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(exe):
        return None
    counts, fn = {}, None
    for path in lib_paths:
        out = subprocess.run([exe, "-sass", path], capture_output=True, text=True,
                             timeout=120, check=True).stdout
        for line in out.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = 0
            elif fn and "HMMA" in line:
                counts[fn] += 1
    return counts


def phase_paths(logs: dict) -> None:
    """For each flash wrapper and dtype: the kernel, its route, ptxas's
    registers and spills (when this run built it) and its HMMA count.
    Fails if a tensor-core kernel spills or has no HMMA, or an FMA
    kernel has any."""
    from ps_slm_tpu_torch import _build

    report = ptxas_report(logs)
    hmma = sass_hmma([_build._lib_path(src) for src in ("flash_fwd", "flash_bwd")])
    for wrapper, paths in FLASH_PATHS.items():
        for dt, key, route in paths:
            regs, spill = next((v for n, v in report.items() if key in n), (None, None))
            n_hmma = None if hmma is None else next(
                (c for n, c in hmma.items() if key in n), None)
            ptxas = ("ptxas: not measured (library built before this run)" if regs is None
                     else f"ptxas: {regs} registers, {spill} bytes spilled")
            sass = "not measured" if n_hmma is None else str(n_hmma)
            print(f"path {wrapper} {dt}: {key} ({route}); {ptxas}; HMMA in SASS {sass}",
                  flush=True)
            if route == "tensor cores" and (spill or n_hmma == 0):
                fail(f"{wrapper} {dt}: the tensor-core kernel spills or has no HMMA")
            if route == "fp32 FMA" and n_hmma:
                fail(f"{wrapper} {dt}: the FMA kernel has HMMA")
    for key in ("layer_norm_bwd_kernelI13__nv_bfloat16", "layer_norm_bwd_kernelIf"):
        name = next((n for n in report if key in n), None)
        regs, spill = report[name] if name else (None, None)
        ptxas = ("ptxas: not measured (library built before this run)" if regs is None
                 else f"ptxas: {regs} registers, {spill} bytes spilled")
        print(f"path layer_norm_bwd: {key}; {ptxas}; dynamic shared memory 2 x 4 x d bytes "
              f"(200440 at d = 25055)", flush=True)
    found = sorted(((m.groups(), v) for n, v in report.items() if (m := NORM_KERNEL.search(n))),
                   key=lambda kv: tuple(g or "" for g in kv[0]))
    if not found:
        print("path norms: ptxas: not measured (library built before this run)", flush=True)
    for (kernel, ty, num, flag), (regs, spill) in found:
        dt = "bf16" if ty.endswith("bfloat16") else "f32"
        what = [dt]
        if num:
            what.append(f"{num} chunks a lane")
        if flag:
            what.append((("RMSNorm", "LayerNorm") if kernel == "norm_fwd_vec_kernel"
                         else ("no dw/db", "dw/db") if kernel == "layer_norm_bwd_vec_kernel"
                         else ("no dw", "dw"))[int(flag)])
        what = ", ".join(what)
        print(f"path norms: {kernel} ({what}); ptxas: {regs} registers, {spill} bytes "
              f"spilled", flush=True)
        if kernel in VEC_KERNELS and dt == "bf16" and spill:
            fail(f"{kernel} ({what}): a bf16 vectorised norm kernel spills")


def route_taken(name, routes, before, n, d, dt) -> str:
    """", route ..." for the log line of a norm call that moved its route
    counters from ``before`` (empty for kernels without routes); fails
    where a main-path shape in bf16 did not take its route."""
    if routes is None:
        return ""
    moved = [r for r in routes if routes[r] != before[r]]
    want = MAIN_ROUTES[name].get((n, d))
    if dt == "bf16" and want and moved != [want]:
        fail(f"{name} [{n},{d}] bf16: a main-path shape took the route {moved}, not {want!r}")
    return f", route {'/'.join(moved)}"


# the forward kernels' cases of phase 3: flash (label, B, S, Hq, Hkv, causal,
# window starts, window ends) at the encoder's (non-causal, right-padded),
# the LLM prefill's (causal GQA, left-padded) and the text-only step's
# shapes; norms (wrapper, rows, width, posterior rows' kind or None for
# normal rows) at the serving and audio training shapes, the text-only
# projector's rows (640 = 5 x 128 frames) and LLM rows (795 = 5 x 159), and
# the beam decode's 16 rows (4 x 4 beams)
FLASH_CASES = (
    ("encoder", 4, 516, 4, 4, False, [0, 0, 0, 0], [516, 404, 304, 260]),
    ("llm_prefill", 4, 543, 12, 2, True, [0, 112, 212, 256], [543] * 4),
    TEXT_ONLY_FLASH,
)
NORM_CASES = (
    ("layer_norm_fwd", 2064, 560, None), ("layer_norm_fwd", 2064, 512, None),
    ("layer_norm_fwd", 2064, 25055, None), ("layer_norm_fwd", 640, 25055, "mixed"),
    ("layer_norm_fwd", 640, 25055, "clean"), ("rms_norm_fwd", 2172, 1536, None),
    ("rms_norm_fwd", 4, 1536, None), ("rms_norm_fwd", 16, 1536, None),
    ("rms_norm_fwd", 795, 1536, None),
)


def phase_kernels(torch, dev, results, flash_cases=FLASH_CASES, norm_cases=NORM_CASES,
                  tag: str = ""):
    """Phase 3's forward kernels against their plain versions, timed, at
    ``flash_cases`` and ``norm_cases`` (phases 6 and 7 pass their largest
    batches'; ``tag`` labels the norm rows)."""
    import torch.nn.functional as F

    from ps_slm_tpu_torch.ops import flash_attention as fa
    from ps_slm_tpu_torch.ops import norms

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    g = torch.Generator(device=dev).manual_seed(0)

    def entry(name):
        return results.setdefault(name, {"max_abs_err": 0.0, "shapes": []})

    for label, b, s, hq, hkv, causal, starts, ends in flash_cases:
        d = fa.HEAD_DIM
        start = torch.tensor(starts, dtype=torch.int32, device=dev)
        end = torch.tensor(ends, dtype=torch.int32, device=dev)
        pos = torch.arange(s, device=dev)
        valid = (pos[None] >= start[:, None]) & (pos[None] < end[:, None])   # [B,T]
        mask = valid[:, None, None, :].expand(b, 1, s, s)
        if causal:
            mask = mask & (pos[None, :] <= pos[:, None])[None, None]
        pairs = float(mask.sum()) * hq                          # valid (q, k) pairs
        for dt, dtype in dtypes.items():
            q = torch.randn(b, s, hq, d, device=dev, generator=g).to(dtype)
            k = torch.randn(b, s, hkv, d, device=dev, generator=g).to(dtype)
            v = torch.randn(b, s, hkv, d, device=dev, generator=g).to(dtype)
            scale = d ** -0.5
            out, lse = fa.flash_attention_fwd(q, k, v, start, end, causal=causal, scale=scale)
            torch.cuda.synchronize()
            r_out, r_lse = fa.flash_attention_ref(q, k, v, start, end, causal=causal, scale=scale)
            err = max(compare(torch, out, r_out, dt, f"flash {label} {dt} out"),
                      compare(torch, lse, r_lse, "f32", f"flash {label} {dt} lse"))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            ms, plain, lib = timed_once(("flash fwd", b, s, hq, hkv, causal, tuple(starts),
                                         tuple(ends), dt), lambda: (
                time_ms(torch, lambda: fa.flash_attention_fwd(
                    q, k, v, start, end, causal=causal, scale=scale)),
                time_ms(torch, lambda: fa.flash_attention_ref(
                    q, k, v, start, end, causal=causal, scale=scale), iters=4),
                time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True))))
            esize = q.element_size()
            nbytes = (q.numel() * 2 + k.numel() * 2) * esize + lse.numel() * 4
            bms, by = bound(nbytes, 4.0 * d * pairs, dt)
            e = entry("flash_attention_fwd")
            e["max_abs_err"] = max(e["max_abs_err"], err)
            e["shapes"].append(dict(shape=label, dtype=dt, ms=ms, plain_ms=plain,
                                    library_ms=lib, bound_ms=bms, bound_by=by, err=err))
            print(f"kernel flash_attention_fwd {label} B{b} S{s} Hq{hq} Hkv{hkv} "
                  f"causal={causal} {dt}: err {err:.3e} ms {ms:.4f} plain {plain:.4f} "
                  f"sdpa {lib:.4f} bound {bms:.4f} ({by})", flush=True)

    for name, n, d, kind, *eps in norm_cases:
        eps = eps[0] if eps else 1e-5
        for dt, dtype in dtypes.items():
            x = (posterior_rows(torch, dev, dtype, kind, n, d) if kind else
                 (torch.randn(n, d, device=dev, generator=g) * 3 + 1).to(dtype))
            w = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(dtype)
            bb = (0.1 * torch.randn(d, device=dev, generator=g)).to(dtype)
            esize = x.element_size()
            if name == "layer_norm_fwd":
                run = lambda: norms.layer_norm_fwd(x, w, bb, eps)     # noqa: E731
                ref = lambda: norms.layer_norm_ref(x, w, bb, eps)     # noqa: E731
                lib = lambda: F.layer_norm(x, (d,), w, bb, eps)      # noqa: E731
                nbytes, flops = 2 * n * d * esize + 2 * d * esize + 8 * n, 8.0 * n * d
            else:
                run = lambda: norms.rms_norm_fwd(x, w)                # noqa: E731
                ref = lambda: norms.rms_norm_ref(x, w)                # noqa: E731
                lib = lambda: F.rms_norm(x, (d,), w, 1e-6)           # noqa: E731
                nbytes, flops = 2 * n * d * esize + d * esize + 4 * n, 4.0 * n * d
            routes = getattr(getattr(norms, name), "routes", None)
            before = dict(routes or {})
            got = run()
            torch.cuda.synchronize()
            route = route_taken(name, routes, before, n, d, dt)
            err = max(compare(torch, a, r, dt if i == 0 else "f32", f"{name} [{n},{d}] {dt}")
                      for i, (a, r) in enumerate(zip(got, ref())))
            ms, plain, lib_ms, host_ms, host_lib = timed_once(
                (name, n, d, kind, eps, dt), lambda: (
                    time_ms(torch, run), time_ms(torch, ref), time_ms(torch, lib),
                    eager_ms(torch, run), eager_ms(torch, lib)))
            bms, by = bound(nbytes, flops, dt)
            e = entry(name)
            e["max_abs_err"] = max(e["max_abs_err"], err)
            label = (f"{tag} " * bool(tag) + f"{n}x{d}" + (f" {kind}" if kind else "")
                     + (f" eps{eps:g}" if eps != 1e-5 else ""))
            e["shapes"].append(dict(shape=label, dtype=dt, ms=ms, plain_ms=plain,
                                    library_ms=lib_ms, bound_ms=bms, bound_by=by, err=err))
            print(f"kernel {name} {f'{tag} ' * bool(tag)}[{n},{d}]{f' {kind}' if kind else ''}"
                  f"{f' eps {eps:g}' if eps != 1e-5 else ''} "
                  f"{dt}: err {err:.3e} ms {ms:.4f} plain {plain:.4f} "
                  f"library {lib_ms:.4f} bound {bms:.4f} ({by}); eager call {host_ms:.4f}, "
                  f"library eager {host_lib:.4f}{route}", flush=True)


def phase_ln_variants(torch, dev) -> None:
    """``--variants``: the LayerNorm forward's designs at the main paths'
    shapes in both dtypes, each against its plain version and timed by
    CUDA-graph replay: the vectorised route at 1 to 8 blocks an SM, the
    route ``ln_route`` gives the wider rows (staged, or held where a row's
    buffers do not fit in shared memory; csrc/norms.cu,
    LAYER_NORM_WIDE_DESIGN), and the general kernel (the design before the
    routes) at every shape."""
    from ps_slm_tpu_torch import _build
    from ps_slm_tpu_torch.ops import norms

    lib = _build.load("norms", norms._SIGNATURES)
    g = torch.Generator(device=dev).manual_seed(2)
    for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for n, d in ((2064, 512), (2064, 560), (2064, 25055)):
            x = (torch.randn(n, d, device=dev, generator=g) * 3 + 1).to(dtype)
            w = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(dtype)
            bb = (0.1 * torch.randn(d, device=dev, generator=g)).to(dtype)
            y = torch.empty_like(x)
            mu, rstd = (torch.empty(n, 1, device=dev) for _ in range(2))
            args = (dev.index, _build.DTYPE_CODES[dtype], x.data_ptr(), w.data_ptr(), bb.data_ptr(),
                    y.data_ptr(), mu.data_ptr(), rstd.data_ptr(), n, d, 1e-5)
            variants = {"general": lambda: lib.ps_layer_norm_fwd(*args, _build.stream_ptr(x))}
            if d * x.element_size() <= norms.VEC_ROW_BYTES:
                for per in (1, 2, 3, 4, 6, 8):
                    variants[f"vec {per} blocks/SM"] = lambda per=per: lib.ps_norm_fwd_vec(
                        *args, norms._blocks(x, n, per), _build.stream_ptr(x))
            else:
                route = norms.ln_route(d, dtype, ())
                variants[route] = lambda route=route: getattr(lib, f"ps_layer_norm_fwd_{route}")(
                    *args, norms._blocks(x, n, 1), _build.stream_ptr(x))
            want = norms.layer_norm_ref(x, w, bb)
            bms, by = bound(2 * n * d * x.element_size() + 2 * d * x.element_size() + 8 * n,
                            8.0 * n * d, dt)
            for label, fn in variants.items():
                y.zero_()
                err = fn()
                if err:
                    print(f"variant layer_norm_fwd [{n},{d}] {dt} {label}: refused ({err})",
                          flush=True)
                    continue
                torch.cuda.synchronize()
                e = max(compare(torch, a, r, dt if i == 0 else "f32", f"variant {label}")
                        for i, (a, r) in enumerate(zip((y, mu, rstd), want)))
                print(f"variant layer_norm_fwd [{n},{d}] {dt} {label}: err {e:.3e} ms "
                      f"{time_ms(torch, fn):.4f} bound {bms:.4f} ({by})", flush=True)


def phase_ln_bwd_variants(torch, dev) -> None:
    """``--variants``: the LayerNorm backward's designs with dw/db at the
    encoder's (760 x 560 / 512) and the q-former's (256 x 768 at eps 1e-12,
    256 x 1536) rows in both dtypes, each kernel followed by the fixed-order
    sum of its partial rows, against the plain version and timed by
    CUDA-graph replay: the vectorised route at 1 to 8 blocks an SM (where
    the row fits it), also with at least 4 rows a block (a warp each: fewer
    partial rows), and the wide kernel (the only design before it) at one
    block an SM."""
    from ps_slm_tpu_torch import _build
    from ps_slm_tpu_torch.ops import norms

    lib = _build.load("norms", norms._SIGNATURES)
    vlib = _build.load("ln_bwd", norms._LN_BWD_SIGNATURES)
    g = torch.Generator(device=dev).manual_seed(3)
    for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for n, d, eps in ((760, 560, 1e-5), (760, 512, 1e-5), (256, 768, 1e-12),
                          (256, 1536, 1e-5)):
            x = (torch.randn(n, d, device=dev, generator=g) * 3 + 1).to(dtype)
            w = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(dtype)
            bb = (0.1 * torch.randn(d, device=dev, generator=g)).to(dtype)
            gy = torch.randn(n, d, device=dev, generator=g).to(dtype)
            _, mu, rstd = norms.layer_norm_ref(x, w, bb, eps)
            want = norms.layer_norm_bwd_ref(x, w, mu, rstd, gy)
            dx, dw, db = torch.empty_like(x), torch.empty_like(w), torch.empty_like(w)
            code = _build.DTYPE_CODES[dtype]

            def variant(launch, nb):
                part = torch.empty((2, nb, d), device=dev)

                def run():   # on the current stream: a CUDA graph's while one is captured
                    st = _build.stream_ptr(x)
                    err = launch(dev.index, code, x.data_ptr(), w.data_ptr(), mu.data_ptr(),
                                 rstd.data_ptr(), gy.data_ptr(), dx.data_ptr(),
                                 part[0].data_ptr(), part[1].data_ptr(), n, d, nb, st)
                    return err or lib.ps_layer_norm_dwdb_sum(
                        dev.index, code, part[0].data_ptr(), part[1].data_ptr(), dw.data_ptr(),
                        db.data_ptr(), nb, d, st)
                return run

            esize = x.element_size()
            variants = {f"vec {per} blocks/SM{f', >= {rows} rows a block' * (rows > 1)}":
                        variant(vlib.ps_layer_norm_bwd_vec, norms._blocks(x, n, per, rows))
                        for rows in (1, 4) for per in (1, 2, 3, 4, 6, 8)
                        if d * esize <= norms.VEC_ROW_BYTES}
            variants["wide"] = variant(lib.ps_layer_norm_bwd, norms._blocks(x, n, 1))
            bms, by = bound(3 * n * d * esize + 3 * d * esize + 8 * n, 13.0 * n * d, dt)
            for label, fn in variants.items():
                dx.zero_()
                err = fn()
                if err:
                    fail(f"variant layer_norm_bwd [{n},{d}] {dt} {label}: refused ({err})")
                torch.cuda.synchronize()
                e = max(compare(torch, a, r, dt, f"variant layer_norm_bwd {label}",
                                1.0 if i == 0 else n ** 0.5)
                        for i, (a, r) in enumerate(zip((dx, dw, db), want)))
                print(f"variant layer_norm_bwd [{n},{d}] eps {eps:g} {dt} {label} (kernel + "
                      f"sum): err {e:.3e} ms {time_ms(torch, fn):.4f} bound {bms:.4f} ({by}) "
                      f"[{CARD}]", flush=True)


# the backward kernels' cases of phase 3: flash dq/dkv (as FLASH_CASES) at
# the LLM's causal GQA attention at bench.py's training shape (every row
# full, as SDPA's is_causal takes it), a ragged case with a left-padded
# row, a right-padded row and a row with no valid key, and the text-only
# step's; norms (wrapper, rows, width, posterior rows' kind or None) at the
# projector's LayerNorm and the LLM's RMSNorm (5 x 543 merged rows), each
# also at the text-only step's rows, and the LayerNorm backward at 12b's
# encoder rows (8 x 95, 560 and 512 wide: its vectorised route)
FLASH_BWD_CASES = (
    ("training", 5, 543, 12, 2, True, [0] * 5, [543] * 5),
    ("ragged", 4, 543, 12, 2, True, [0, 112, 0, 0], [543, 543, 300, 0]),
    TEXT_ONLY_FLASH,
)
NORM_BWD_CASES = (
    ("layer_norm_bwd", 2560, 25055, None), ("layer_norm_bwd", 640, 25055, "mixed"),
    ("layer_norm_bwd", 760, 560, None), ("layer_norm_bwd", 760, 512, None),
    ("rms_norm_bwd", 2715, 1536, None), ("rms_norm_bwd", 795, 1536, None),
)


def phase_kernels_bwd(torch, dev, results, flash_cases=FLASH_BWD_CASES,
                      norm_cases=NORM_BWD_CASES, tag: str = ""):
    """The backward kernels against their plain versions at ``flash_cases``
    and ``norm_cases`` (phase 7 passes its largest batches'; ``tag``
    labels the norm rows).  flash dq and
    dkv share one plain version (dq, dk, dv at once) and one library call
    (the autograd backward of SDPA), whose times are given to both."""
    import torch.nn.functional as F

    from ps_slm_tpu_torch.ops import flash_attention as fa
    from ps_slm_tpu_torch.ops import norms

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    g = torch.Generator(device=dev).manual_seed(1)

    def entry(name):
        return results.setdefault(name, {"max_abs_err": 0.0, "shapes": []})

    def record(name, label, dt, ms, plain, lib, method, nbytes, flops, err):
        bms, by = bound(nbytes, flops, dt)
        e = entry(name)
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["shapes"].append(dict(shape=label, dtype=dt, ms=ms, plain_ms=plain, library_ms=lib,
                                bound_ms=bms, bound_by=by, err=err))
        print(f"kernel {name} {label} {dt}: err {err:.3e} ms {ms:.4f} plain {plain:.4f} "
              f"library {lib:.4f} ({method}) bound {bms:.4f} ({by})", flush=True)

    for label, b, s, hq, hkv, causal, starts, ends in flash_cases:
        d = fa.HEAD_DIM
        scale = d ** -0.5
        start = torch.tensor(starts, dtype=torch.int32, device=dev)
        end = torch.tensor(ends, dtype=torch.int32, device=dev)
        pairs = float(fa._pair_mask(start, end, s, s, causal).sum()) * hq
        for dt, dtype in dtypes.items():
            q, do = (torch.randn(b, s, hq, d, device=dev, generator=g).to(dtype) for _ in range(2))
            k, v = (torch.randn(b, s, hkv, d, device=dev, generator=g).to(dtype) for _ in range(2))
            out, lse = fa.flash_attention_fwd(q, k, v, start, end, causal=causal, scale=scale)
            delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
            args = (q, k, v, start, end, out, lse, do, delta)
            kw = dict(causal=causal, scale=scale)
            dq = fa.flash_attention_dq(*args, **kw)
            dk, dv = fa.flash_attention_dkv(*args, **kw)
            torch.cuda.synchronize()
            want = fa.flash_attention_bwd_ref(q, k, v, start, end, out, lse, do, **kw)
            errs = [compare(torch, a, r, dt, f"flash {n} {label} {dt}")
                    for n, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), want)]
            empty = (lse == fa.NEG_INF).transpose(1, 2)
            if label == "ragged" and (not bool(empty.any()) or bool(dq[empty].any())):
                fail(f"flash dq {label} {dt}: a query row with no valid key has a gradient")
            # SDPA takes the ragged windows as a boolean mask (its values on
            # the empty row are NaN: only its time is used)
            mask = None if label == "training" else fa._pair_mask(start, end, s, s, causal)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
            ms_dq, ms_dkv, plain, (lib, method) = timed_once(
                ("flash bwd", b, s, hq, hkv, causal, tuple(starts), tuple(ends), mask is None, dt),
                lambda: (
                    time_ms(torch, lambda: fa.flash_attention_dq(*args, **kw)),
                    time_ms(torch, lambda: fa.flash_attention_dkv(*args, **kw)),
                    time_ms(torch, lambda: fa.flash_attention_bwd_ref(
                        q, k, v, start, end, out, lse, do, **kw), iters=4),
                    backward_ms(torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, is_causal=mask is None, scale=scale,
                        enable_gqa=True), (qt, kt, vt), do.transpose(1, 2))))
            esize = q.element_size()
            stats = 2 * lse.numel() * 4
            record("flash_attention_dq", label, dt, ms_dq, plain, lib, method,
                   (3 * q.numel() + 2 * k.numel()) * esize + stats, 6.0 * d * pairs, errs[0])
            record("flash_attention_dkv", label, dt, ms_dkv, plain, lib, method,
                   (2 * q.numel() + 4 * k.numel()) * esize + stats, 8.0 * d * pairs,
                   max(errs[1:]))
            print(f"flash backward {label} {dt}: dq + dk/dv {ms_dq + ms_dkv:.4f} ms against "
                  f"SDPA's whole backward {lib:.4f} ms ({(ms_dq + ms_dkv) / lib:.2f}x)", flush=True)

    for name, n, d, kind, *eps in norm_cases:
        eps = eps[0] if eps else 1e-5
        shape = (f"{tag} " * bool(tag) + f"{n}x{d}" + (f" {kind}" if kind else "")
                 + (f" eps{eps:g}" if eps != 1e-5 else ""))
        for dt, dtype in dtypes.items():
            x = (posterior_rows(torch, dev, dtype, kind, n, d) if kind else
                 (torch.randn(n, d, device=dev, generator=g) * 3 + 1).to(dtype))
            w = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(dtype)
            bb = (0.1 * torch.randn(d, device=dev, generator=g)).to(dtype)
            gy = torch.randn(n, d, device=dev, generator=g).to(dtype)
            esize = x.element_size()
            xr, wr, br = (t.detach().requires_grad_(True) for t in (x, w, bb))
            # frozen: F's backward with the weights not requiring grad, the
            # bytes and operations of dx alone
            if name == "layer_norm_bwd":
                _, mu, rstd = norms.layer_norm_fwd(x, w, bb, eps)
                bwd, bwd_ref, args = norms.layer_norm_bwd, norms.layer_norm_bwd_ref, (x, w, mu, rstd, gy)
                library = lambda: backward_ms(                          # noqa: E731
                    torch, lambda: F.layer_norm(xr, (d,), wr, br, eps), (xr, wr, br), gy)
                frozen = lambda: backward_ms(                           # noqa: E731
                    torch, lambda: F.layer_norm(xr, (d,), w, bb, eps), (xr,), gy)
                nbytes = 3 * n * d * esize + 3 * d * esize + 8 * n
                flops = 13.0 * n * d
                frozen_bytes, frozen_flops = nbytes - 2 * d * esize, flops - 3.0 * n * d
            else:
                _, rstd = norms.rms_norm_fwd(x, w)
                bwd, bwd_ref, args = norms.rms_norm_bwd, norms.rms_norm_bwd_ref, (x, w, rstd, gy)
                library = lambda: backward_ms(                          # noqa: E731
                    torch, lambda: F.rms_norm(xr, (d,), wr, 1e-6), (xr, wr), gy)
                frozen = lambda: backward_ms(                           # noqa: E731
                    torch, lambda: F.rms_norm(xr, (d,), w, 1e-6), (xr,), gy)
                nbytes = 3 * n * d * esize + 2 * d * esize + 4 * n
                flops = 9.0 * n * d
                frozen_bytes, frozen_flops = nbytes - d * esize, flops - 2.0 * n * d
            routes = getattr(bwd, "routes", None)
            before = dict(routes or {})
            got = bwd(*args)
            torch.cuda.synchronize()
            route = route_taken(name, routes, before, n, d, dt)
            want = bwd_ref(*args)
            err = max(compare(torch, a, r, dt, f"{name} [{n},{d}] {dt}", 1.0 if i == 0 else n ** 0.5)
                      for i, (a, r) in enumerate(zip(got, want)))
            ms, plain, (lib_w, method), kernel_ms = timed_once((name, n, d, kind, eps, dt), lambda: (
                time_ms(torch, lambda: bwd(*args)), time_ms(torch, lambda: bwd_ref(*args)),
                library(), time_ms(torch, lambda: bwd(*args, weight_grad=False))))
            record(name, shape, dt, ms, plain, lib_w, method, nbytes, flops, err)
            # frozen weights (the RMSNorm's training main path): dx alone,
            # against F's backward with the weights not requiring grad (the
            # LayerNorm's wide kernel still writes its partial rows, unsummed)
            before = dict(routes or {})
            dx = bwd(*args, weight_grad=False)[0]
            torch.cuda.synchronize()
            route_frozen = route_taken(name, routes, before, n, d, dt)
            err = compare(torch, dx, want[0], dt, f"{name} [{n},{d}] {dt} frozen w")
            lib, method = timed_once((name, n, d, kind, eps, dt, "frozen w"), frozen)
            record(name, f"{shape} frozen w", dt, kernel_ms, plain, lib, method,
                   frozen_bytes, frozen_flops, err)
            print(f"kernel {name} {shape} {dt}{route}; frozen w{route_frozen}; with dw"
                  f"{'/db' if name == 'layer_norm_bwd' else ''}, kernel + sum {ms:.4f} ms, "
                  f"library {lib_w:.4f} ms ({ms / lib_w:.2f}x)", flush=True)


def path_fp32_run(device) -> tuple:
    """Phase 4 on ``device`` (the model built on the CPU from its seed and
    moved): the serving batch's merged embeddings, mask and positions,
    prefill logits and 8 greedy tokens, on the CPU."""
    import torch

    from ps_slm_tpu_torch.config import SENSEVOICE_SMALL, half_audio_configs
    from ps_slm_tpu_torch.inference.generate import _prefill, generate
    from ps_slm_tpu_torch.models.tasu import model_factory, prepare_merged

    tc, mc = half_audio_configs(*FP32_DEPTH, seed=0)
    model = model_factory(tc, mc, device="cpu").to(device)
    model.speech_token_id = SPEECH_TOKEN
    # the main path's lengths: multi-tile flash calls, skipped and fully
    # masked tiles, left-padded rows
    batch = serving_batch(torch, SENSEVOICE_SMALL["input_size"], seed=1)
    bd = {k: v.to(device) for k, v in batch.items()}
    with torch.inference_mode():
        merged = prepare_merged(model, bd, left_padding=True)
        logits, _, _ = _prefill(
            model.llm, merged.embeds, merged.attention_mask, merged.position_ids,
            merged.embeds.shape[1] + 8,
        )
    tokens = generate(model, bd, eos_token_id=EOS, num_beams=1, max_new_tokens=8, device=device)
    return (merged.embeds.cpu(), merged.attention_mask.cpu(), merged.position_ids.cpu(),
            logits.cpu(), tokens.cpu())


def phase_path_fp32(torch, dev, ref):
    """Phase 4: :func:`path_fp32_run` on the card against ``ref``, its CPU
    run (a future of the reference worker)."""
    t0 = time.time()
    e_g, a_g, p_g, l_g, t_g = path_fp32_run(dev)
    e_c, a_c, p_c, l_c, t_c = ref.result()
    if not (torch.equal(a_c, a_g) and torch.equal(p_c, p_g)):
        fail("fp32 path: merged mask or positions differ between card and CPU")
    emb_err = float((e_c - e_g).abs().max())
    logit_err = float((l_c - l_g).abs().max())
    print(f"path fp32 (2+1 encoder blocks, 1 LLM layer, full width): embeds err "
          f"{emb_err:.3e} prefill logits err {logit_err:.3e} (tol {PATH_TOL}); "
          f"tokens card {t_g.tolist()} cpu {t_c.tolist()} ({time.time() - t0:.1f} s)",
          flush=True)
    if not (emb_err <= PATH_TOL and logit_err <= PATH_TOL):
        fail("fp32 path: card and CPU disagree beyond the tolerance")
    if not torch.isfinite(l_g).all() or not torch.equal(t_c, t_g):
        fail("fp32 path: greedy tokens differ between card and CPU")


def train_fp32_run(device) -> tuple:
    """Phase 4b on ``device``: two training steps' metrics and the trained
    projector, on the CPU; fails on a frozen weight that changed, a
    projector that did not move or optimizer state off the projector's."""
    import torch

    from ps_slm_tpu_torch.config import SENSEVOICE_SMALL, half_audio_configs
    from ps_slm_tpu_torch.models.tasu import model_factory
    from ps_slm_tpu_torch.training.step import make_train_step

    tc, mc = half_audio_configs(*FP32_DEPTH, seed=0)
    tc.lr, tc.warmup_steps = 1e-3, 1
    model = model_factory(tc, mc, device="cpu").to(device)
    model.speech_token_id = SPEECH_TOKEN
    batch = train_batch(torch, SENSEVOICE_SMALL["input_size"], TRAIN_RAGGED_FRAMES, seed=3)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(model, tc, device=device)
    metrics = []
    for _ in range(2):
        m = step(batch)
        metrics.append({k: float(v) for k, v in m.items()})
    params = dict(model.named_parameters())
    frozen_same = all(torch.equal(params[n], p) for n, p in start.items()
                      if n not in step.trainable)
    moved = any(not torch.equal(params[n], start[n]) for n in step.trainable)
    if not (frozen_same and moved and len(step.optimizer.state) == 6):
        fail(f"fp32 training on {torch.device(device).type}: frozen weights changed "
             f"({not frozen_same}), projector did not move ({not moved}), or optimizer state "
             f"for {len(step.optimizer.state)} tensors, not the projector's 6")
    return metrics, {n: params[n].detach().cpu() for n in step.trainable}


def phase_train_fp32(torch, dev, ref):
    """Phase 4b: two training steps of the half_audio recipe at full width
    and reduced depth, fp32, on the card (:func:`train_fp32_run`) against
    ``ref``, the CPU's from the same weights."""
    t0 = time.time()
    m_g, p_g = train_fp32_run(dev)
    m_c, p_c = ref.result()
    errs = {k: max(abs(a[k] - b[k]) for a, b in zip(m_c, m_g)) for k in ("loss", "acc", "ntokens")}
    w_err = max(float((p_c[n] - p_g[n]).abs().max()) for n in p_c)
    print(f"train fp32 (2+1 encoder blocks, 1 LLM layer, full width, frames "
          f"{list(TRAIN_RAGGED_FRAMES)}): losses card {[m['loss'] for m in m_g]} cpu "
          f"{[m['loss'] for m in m_c]}; acc card {[m['acc'] for m in m_g]}; ntokens "
          f"{[m['ntokens'] for m in m_g]}; max err loss {errs['loss']:.3e} acc "
          f"{errs['acc']:.3e} ntokens {errs['ntokens']:.0f}, projector after step 2 "
          f"{w_err:.3e} (tol {PATH_TOL}); frozen weights bit-identical, projector moved "
          f"({time.time() - t0:.1f} s)", flush=True)
    if errs["ntokens"] != 0 or max(errs["loss"], errs["acc"], w_err) > PATH_TOL:
        fail("fp32 training: card and CPU disagree beyond the tolerance")
    if m_g[0]["loss"] != m_g[1]["loss"]:
        fail("fp32 training: the first update (lr 0) changed the loss")


class TrainProbe:
    """Hooks around ``cli.finetune.main`` (and the ``cli.decode`` factory):
    each micro-step's loss, wall ms with the host synchronised before and
    after (the loop's own timer times dispatch only), audio seconds, launch
    counts (the counters' deltas over the call) and the peak memory after
    it; each evaluation's wall, batches and launches; each train-state save
    (seconds, bytes) and restore (seconds); the fast-forward's seconds; the
    model the factory built; and, at micro-step ``profile_at``, one step
    under ``torch.profiler``.  On the CPU nothing synchronises and the
    counters stay at 0.  A micro-step is warm when a batch of its shapes
    ran before in this process through the same branch, audio or text-only
    (``shapes_run``; remat runs the same GEMMs): the first use of a shape
    pays for the allocator's growth and the GEMM libraries' choice of
    kernels.  ``largest`` keeps the batch with the most text ids and
    samples (text-only: transcript ids)."""

    shapes_run: set = set()

    def __init__(self, torch, dev, profile_at=None):
        self.torch, self.dev, self.profile_at = torch, dev, profile_at
        self.cuda = torch.device(dev).type == "cuda"
        self.steps, self.evals, self.saves, self.restores = [], [], [], []
        self.ff_s, self.model, self.prof, self.largest = None, None, None, None
        self.after_save, self.decodes, self.collections, self.gc_start = False, [], [], 0.0

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def counts(self):
        return launch_counts(kernel_counters()) if self.cuda else {}

    def delta(self, before):
        after = self.counts()
        return {n: after[n] - before[n] for n in after}

    def __enter__(self):
        from ps_slm_tpu_torch import registry
        from ps_slm_tpu_torch.data import audio_io
        from ps_slm_tpu_torch.training import checkpoint as ckpt
        from ps_slm_tpu_torch.training import loop
        from ps_slm_tpu_torch.training import step as step_mod

        probe = self
        self.saved = [(step_mod.TrainStep, "__call__", step_mod.TrainStep.__call__),
                      (loop, "evaluate", loop.evaluate),
                      (loop, "_fast_forward", loop._fast_forward),
                      (ckpt, "save_train_state", ckpt.save_train_state),
                      (ckpt, "restore_train_state", ckpt.restore_train_state)]
        real_call, real_eval, real_ff, real_save, real_restore = (x[2] for x in self.saved)
        self.saved.append((audio_io, "load_audio", audio_io.load_audio))
        real_load = audio_io.load_audio
        self.real_factory = registry.get_model_factory("tasu")

        def load(*args, **kwargs):
            t = time.perf_counter()
            try:
                return real_load(*args, **kwargs)
            finally:
                probe.decodes.append((t, time.perf_counter()))

        def collected(phase, info):
            if phase == "start":
                probe.gc_start = time.perf_counter()
            else:
                probe.collections.append((probe.gc_start, time.perf_counter()))

        def overlap_ms(spans, t0, t1):
            return sum(max(0.0, min(b, t1) - max(a, t0)) for a, b in spans) * 1e3

        def call(state, batch, draws=None):
            probe.sync()
            before = probe.counts()
            t = time.perf_counter()
            profiled_step = len(probe.steps) == probe.profile_at
            if profiled_step:
                out = []
                probe.prof = profiled(probe.torch, lambda: out.append(real_call(state, batch, draws)))
                m = out[0]
            else:
                m = real_call(state, batch, draws)
            loss = float(m["loss"])
            t_end = time.perf_counter()
            ms = (t_end - t) * 1e3
            wl = batch.get("waveform_length")
            audio = 0.0
            if wl is not None:
                valid = batch.get("batch_valid")
                audio = float((wl if valid is None else wl[valid]).sum()) / 16000
            peak = probe.torch.cuda.max_memory_allocated() / 1e9 if probe.cuda else 0.0
            shape = (probe.model.flags.needs_encoder,
                     *sorted((k, tuple(v.shape)) for k, v in batch.items()))
            probe.steps.append(dict(loss=loss, ms=ms, audio=audio, launches=probe.delta(before),
                                    peak=peak, accum=state.accum.mini_step,
                                    warm=shape in TrainProbe.shapes_run,
                                    after_save=probe.after_save, profiled=profiled_step,
                                    decode_ms=overlap_ms(probe.decodes, t, t_end),
                                    gc_ms=overlap_ms(probe.collections, t, t_end)))
            probe.after_save = False
            TrainProbe.shapes_run.add(shape)
            audio_in = batch["waveform"] if probe.model.flags.needs_encoder else batch["gt_ids"]
            size = batch["input_ids"].numel() + audio_in.numel()
            if probe.largest is None or size > probe.largest[0]:
                probe.largest = (size, batch)
            return m

        def evaluate(model, batches, device, eval_step=None):
            n = [0]

            def counted():
                for b in batches:
                    n[0] += 1
                    yield b

            probe.sync()
            before = probe.counts()
            t = time.perf_counter()
            out = real_eval(model, counted(), device, eval_step)
            probe.sync()
            probe.evals.append(dict(s=time.perf_counter() - t, batches=n[0],
                                    launches=probe.delta(before), loss=out["eval_loss"]))
            return out

        def fast_forward(*args):
            t = time.perf_counter()
            out = real_ff(*args)
            probe.ff_s = (probe.ff_s or 0.0) + time.perf_counter() - t
            return out

        def save(path, state):
            probe.sync()
            t = time.perf_counter()
            n = real_save(path, state)
            probe.saves.append(dict(path=path, s=time.perf_counter() - t, bytes=n))
            probe.after_save = True
            return n

        def restore(path, state):
            t = time.perf_counter()
            out = real_restore(path, state)
            probe.sync()
            probe.restores.append(dict(path=path, s=time.perf_counter() - t))
            return out

        def factory(*args, **kwargs):
            probe.model = probe.real_factory(*args, **kwargs)
            return probe.model

        step_mod.TrainStep.__call__ = call
        audio_io.load_audio = load
        gc.callbacks.append(collected)
        self.collected = collected
        loop.evaluate, loop._fast_forward = evaluate, fast_forward
        ckpt.save_train_state, ckpt.restore_train_state = save, restore
        registry.register_model("tasu")(factory)
        return self

    def __exit__(self, *exc):
        from ps_slm_tpu_torch import registry

        for obj, name, fn in self.saved:
            setattr(obj, name, fn)
        gc.callbacks.remove(self.collected)
        registry.register_model("tasu")(self.real_factory)
        return False

    def losses(self):
        return [s["loss"] for s in self.steps]

    def summary(self, audio_read: bool = True) -> str:
        """Step wall median (min-max) over the micro-steps (the profiled
        one, slowed by the profiler, left out) and over the warm ones; each
        step's wall, marked ``w`` warm, ``s`` the first step after a
        train-state write, ``p`` profiled, with the ms of audio decoding
        (``d``, the prefetch thread's ``load_audio`` calls) and of Python's
        garbage collection (``g``) inside it; audio-s/s (``audio_read``
        False: the batches carry audio the step does not read, so none is
        claimed), peak memory."""
        import statistics

        timed = [s for s in self.steps if not s["profiled"]]
        if not timed:
            return "no steps"
        ms = [s["ms"] for s in timed]
        warm = [s["ms"] for s in timed if s["warm"]]
        audio = sum(s["audio"] for s in timed)
        rate = (f"{audio / (sum(ms) / 1e3):.1f} audio-s/s over {audio:.2f} s of audio" if audio_read
                else f"{audio:.2f} s of audio shipped in the batches and not read by the step")
        each = " ".join(
            f"{st['ms']:.1f}{'w' * st['warm']}{'s' * st['after_save']}{'p' * st['profiled']}"
            + (f"(d{st['decode_ms']:.0f})" if st["decode_ms"] >= 1 else "")
            + (f"(g{st['gc_ms']:.0f})" if st["gc_ms"] >= 1 else "") for st in self.steps)
        return (f"{len(self.steps)} micro-steps, wall median {statistics.median(ms):.2f} ms (min "
                f"{min(ms):.2f}, max {max(ms):.2f}; synchronised, the profiled step left out; each "
                f"[{each}]); warm median "
                + (f"{statistics.median(warm):.2f} ms over {len(warm)}" if warm else "- over 0")
                + f" micro-steps whose batch shapes ran before; {rate}, peak memory "
                f"{max(s['peak'] for s in self.steps):.2f} GB [{CARD}]")


def read_log(path: str) -> str:
    with open(path) as f:
        return f.read()


# 4e's overrides after the half_audio recipe's
FINETUNE_FP32_EXTRA = [
    "++train_config.mixed_precision=false", "++dataset_config.fbank.dither=0.0",
    "++train_config.num_epochs=1", "++train_config.validation_interval=2",
    "++train_config.batching_strategy=padding", "++train_config.batch_size_training=2",
    "++train_config.val_batch_size=4", "++train_config.lr=1e-3", "++train_config.warmup_steps=1",
    "++train_config.save_last=true", "++log_config.log_interval=1"]


def finetune_fp32_assets(root: str) -> tuple:
    """4e's assets (phase 4d's kind, two LLM layers: phase 13a's pipe=2
    splits them) and its 8-utterance train and 4-utterance dev manifests,
    written into ``root``: (assets, model config)."""
    import torch

    from ps_slm_tpu_torch.config import half_audio_configs
    from ps_slm_tpu_torch.models.tasu import model_factory

    tc, mc = half_audio_configs(*FP32_DEPTH_LAYERED, seed=0)
    assets = write_assets(root, model_factory(tc, mc, device="cpu"),
                          llm_dtype=torch.bfloat16, utts={"ark": 1, "wav": 0, "flac": 0})
    write_manifest(os.path.join(root, "train"), {"ark": 6, "wav": 1, "flac": 1},
                   FINETUNE_SECONDS, seed=1)
    write_manifest(os.path.join(root, "dev"), {"ark": 4, "wav": 0, "flac": 0},
                   FINETUNE_SECONDS, seed=2)
    return assets, mc


def finetune_cli_fp32_run(device, root: str = None, assets: dict = None, mc=None,
                          trained: dict = None) -> dict:
    """Phase 4e's finetune CLI run on ``device`` over ``root``'s assets
    (none given: its own copy in a temporary directory, deleted after):
    its losses, evaluations, wall seconds, checkpoints and their exports;
    on the card also its output directory and model, and ``trained``
    filled by :func:`capture_trained`."""
    import torch

    from ps_slm_tpu_torch.cli import finetune

    own = root is None
    if own:
        root = tempfile.mkdtemp(prefix="finetune_cli_fp32_")
        assets, mc = finetune_fp32_assets(root)
    name = torch.device(device).type
    try:
        out = os.path.join(root, name)
        undo = capture_trained(torch, trained) if trained is not None else (lambda: None)
        try:
            with TrainProbe(torch, device) as probe:
                t1 = time.time()
                rc = finetune.main(finetune_args(assets, root, out, llm_dim=mc.llm_dim,
                                                 encoder_dim=mc.encoder_dim)
                                   + FINETUNE_FP32_EXTRA, device=device)
        finally:
            undo()
        if rc != 0:
            fail(f"finetune CLI fp32 on {name}: main returned {rc}")
        steps = sorted(p for p in os.listdir(out) if p.startswith("step_"))
        run = dict(losses=probe.losses(), evals=[e["loss"] for e in probe.evals],
                   wall=time.time() - t1, steps=steps, exports={
                       tag: torch.load(os.path.join(out, tag, "pytorch_model.bin"),
                                       weights_only=True) for tag in steps + ["last"]})
        if not own:
            run.update(out=out, model=probe.model)
        probe.model = probe.largest = None
        return run
    finally:
        if own:
            shutil.rmtree(root, ignore_errors=True)


def phase_finetune_cli_fp32(torch, dev, ref) -> dict:
    """Phase 4e: the finetune CLI (``cli.finetune.main``, the half_audio
    recipe's overrides, fp32, dither 0, lr 1e-3 from the first step) at full
    width and reduced depth on phase 4d's kind of assets and a 8-utterance
    train and 4-utterance dev manifest: 4 steps of 2 rows, validation every
    2, on the card (:func:`finetune_cli_fp32_run`) against ``ref``, the
    CPU's run; per-step losses, eval losses and the exported projectors
    within PATH_TOL; and a resume on the card from ``step_2/state`` that
    reproduces the last two losses bit for bit.  Returns the card run (its
    losses, evaluations, model, ``last/`` export and AdamW's first moments
    after micro-step MOMENT_STEP) and its assets for phase 13a, which
    deletes the directory, and ``against_cpu``, which awaits ``ref`` and
    holds the card's run against it: called after 13a, so that the CPU's
    run goes on beside 13a's instead of the card waiting for it."""
    from ps_slm_tpu_torch.cli import finetune

    what = "finetune CLI fp32"
    t0 = time.time()
    root = tempfile.mkdtemp(prefix="finetune_cli_fp32_")
    try:
        assets, mc = finetune_fp32_assets(root)
        trained: dict = {}
        card = finetune_cli_fp32_run(dev, root, assets, mc, trained)
        if "step_2" not in card["steps"]:
            fail(f"{what}: checkpoints {card['steps']} on the card; want step_2")

        # resume on the card from step_2 (while the CPU's run may still be
        # going): the last two losses, bit for bit (no checkpoint written: the
        # card machine's disk takes a bounded amount of writes)
        out = os.path.join(root, "resumed")
        with TrainProbe(torch, dev) as probe:
            rc = finetune.main(finetune_args(assets, root, out, llm_dim=mc.llm_dim,
                                             encoder_dim=mc.encoder_dim) + FINETUNE_FP32_EXTRA + [
                f"++train_config.resume_from={card['out']}/step_2/state",
                "++train_config.save_model=false", "++train_config.save_last=false"], device=dev)
        skipped = "skipping 2 trained batches" in read_log(os.path.join(out, "train.log"))
        resumed = probe.losses()
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    same = resumed == card["losses"][2:]
    if not (skipped and same):
        fail(f"{what}: the resumed run did not skip 2 batches and reproduce the last two losses")
    t_card = time.time() - t0

    def against_cpu():
        """The card's run against the CPU's (``ref``, awaited here)."""
        t1 = time.time()
        cpu = ref.result()
        if len(card["losses"]) != 4 or card["steps"] != cpu["steps"]:
            fail(f"{what}: {len(card['losses'])} steps, checkpoints {card['steps']} on the card "
                 f"and {cpu['steps']} on the CPU; want 4 steps and step_2 on both")
        loss_err = max(abs(a - b) for a, b in zip(card["losses"] + card["evals"],
                                                  cpu["losses"] + cpu["evals"]))
        proj_err = 0.0
        for tag in card["steps"] + ["last"]:
            a, b = card["exports"][tag], cpu["exports"][tag]
            if sorted(a) != sorted(b) or not all(k.startswith("encoder_projector.") for k in a):
                fail(f"{what}: {tag}'s exports hold other keys than the projector's")
            proj_err = max([proj_err] + [float((a[k] - b[k]).abs().max()) for k in a])
        print(f"{what} (2+1 encoder blocks, 2 LLM layers, full width, 4 steps of 2 rows, "
              f"validation every 2, dither 0): losses card {card['losses']} cpu {cpu['losses']}; "
              f"eval card {card['evals']} cpu {cpu['evals']}; max err {loss_err:.3e}, exported "
              f"projectors {proj_err:.3e} (tol {PATH_TOL}); checkpoints {card['steps']} + last; "
              f"resumed from step_2 on the card: skipped 2 batches {skipped}, losses {resumed} "
              f"bit-identical; main {card['wall']:.1f} s card, {cpu['wall']:.1f} s CPU "
              f"({t_card:.1f} s the card's side, {time.time() - t1:.1f} s the CPU's awaited and "
              f"compared) [{CARD}]", flush=True)
        if max(loss_err, proj_err) > PATH_TOL:
            fail(f"{what}: card and CPU disagree beyond the tolerance")

    return {"root": root, "assets": assets, "mc": mc, "extra": FINETUNE_FP32_EXTRA,
            "losses": card["losses"], "evals": card["evals"], "model": card["model"],
            "moments": trained["moments"], "against_cpu": against_cpu,
            "export": os.path.join(card["out"], "last", "pytorch_model.bin")}


def beam_text_only_fp32_run(device) -> tuple:
    """Phase 4c on ``device`` (phase 4's model, two LLM layers): the beam
    tokens, then two text-only steps' metrics and the trained projector
    (the flags swapped to the paper's recipe, insertion on, the noise drawn
    on the CPU from a seed), on the CPU; fails on a frozen weight that
    changed or a projector that did not move."""
    import torch

    from ps_slm_tpu_torch.config import SENSEVOICE_SMALL, half_audio_configs, text_only_configs
    from ps_slm_tpu_torch.inference.generate import generate
    from ps_slm_tpu_torch.models.tasu import TasuFlags, model_factory
    from ps_slm_tpu_torch.ops.pseudo_posterior import noise_draws
    from ps_slm_tpu_torch.training.step import make_train_step

    tc, mc = half_audio_configs(*FP32_DEPTH_LAYERED, seed=0)
    model = model_factory(tc, mc, device="cpu").to(device)
    model.speech_token_id = SPEECH_TOKEN
    batch = serving_batch(torch, SENSEVOICE_SMALL["input_size"], seed=1)
    toks = generate(model, batch, eos_token_id=EOS, max_new_tokens=FP32_NEW,
                    device=device).cpu()
    tc, _ = text_only_configs(*FP32_DEPTH_LAYERED, seed=0)
    tc.lr, tc.warmup_steps, tc.insert_prob = 1e-3, 1, TEXT_ONLY_INSERT
    batch = gt_batch(torch, SENSEVOICE_SMALL["vocab_size"], seed=3)
    gen = torch.Generator().manual_seed(5)
    draws = [noise_draws(len(TEXT_ONLY_GT_LENS), max(TEXT_ONLY_GT_LENS), gen,
                         insert_prob=tc.insert_prob) for _ in range(2)]
    model.flags = TasuFlags.from_train_config(tc)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(model, tc, device=device)
    metrics = [{k: float(v) for k, v in step(batch, draws=dr).items()} for dr in draws]
    params = dict(model.named_parameters())
    frozen_same = all(torch.equal(params[n], p) for n, p in start.items()
                      if n not in step.trainable)
    moved = any(not torch.equal(params[n], start[n]) for n in step.trainable)
    if not (frozen_same and moved):
        fail(f"fp32 text-only training on {torch.device(device).type}: frozen weights changed "
             f"({not frozen_same}) or the projector did not move ({not moved})")
    return toks, metrics, {n: params[n].detach().cpu() for n in step.trainable}


def phase_beam_text_only_fp32(torch, dev, ref):
    """Phase 4c: beam search and text-only training at full width and
    reduced depth, fp32, on the card (:func:`beam_text_only_fp32_run`)
    against ``ref``, the CPU's from the same weights."""
    t0 = time.time()
    t_g, m_g, p_g = beam_text_only_fp32_run(dev)
    t_c, m_c, p_c = ref.result()
    print(f"beam fp32 (num_beams 4, the default, {FP32_NEW} new tokens): tokens card "
          f"{t_g.tolist()} cpu {t_c.tolist()}", flush=True)
    if not torch.equal(t_c, t_g):
        fail("fp32 beam search: tokens differ between card and CPU")
    errs = {k: max(abs(a[k] - b[k]) for a, b in zip(m_c, m_g)) for k in ("loss", "acc", "ntokens")}
    w_err = max(float((p_c[n] - p_g[n]).abs().max()) for n in p_c)
    print(f"text-only fp32 (gt lengths {list(TEXT_ONLY_GT_LENS)}, insert_prob "
          f"{TEXT_ONLY_INSERT}): losses card {[m['loss'] for m in m_g]} cpu "
          f"{[m['loss'] for m in m_c]}; acc card {[m['acc'] for m in m_g]}; ntokens "
          f"{[m['ntokens'] for m in m_g]}; max err loss {errs['loss']:.3e} acc "
          f"{errs['acc']:.3e} ntokens {errs['ntokens']:.0f}, projector after step 2 "
          f"{w_err:.3e} (tol {PATH_TOL}); frozen weights bit-identical, projector moved "
          f"({time.time() - t0:.1f} s)", flush=True)
    if errs["ntokens"] != 0 or max(errs["loss"], errs["acc"], w_err) > PATH_TOL:
        fail("fp32 text-only training: card and CPU disagree beyond the tolerance")


def decode_cli_fp32_run(device) -> tuple:
    """Phase 4d on ``device``: the decode CLI on its own copy of the assets
    (written from the seeded model into a temporary directory, deleted
    after): the ``_pred`` file's bytes and ``main``'s wall seconds."""
    import torch

    from ps_slm_tpu_torch.cli import decode
    from ps_slm_tpu_torch.config import half_audio_configs
    from ps_slm_tpu_torch.models.tasu import model_factory

    root = tempfile.mkdtemp(prefix="decode_cli_fp32_")
    try:
        tc, mc = half_audio_configs(*FP32_DEPTH, seed=0)
        assets = write_assets(root, model_factory(tc, mc, device="cpu"),
                              llm_dtype=torch.bfloat16, utts=DECODE_FP32_UTTS)
        log = os.path.join(root, "out", "test")
        t1 = time.time()
        rc = decode.main(decode_args(assets, log, FP32_NEW, mc.llm_dim, mc.encoder_dim)
                         + ["++train_config.mixed_precision=false"], device=device)
        wall = time.time() - t1
        if rc != 0:
            fail(f"decode CLI fp32 on {torch.device(device).type}: main returned {rc}")
        with open(log + "_pred", "rb") as f:
            return f.read(), wall
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_decode_cli_fp32(torch, dev, ref) -> None:
    """Phase 4d: the decode CLI (``cli.decode.main``, scripts/decode.sh's
    overrides, fp32, FP32_NEW new tokens) on the card
    (:func:`decode_cli_fp32_run`) against ``ref``, the CPU's run, each on
    the same assets at full width and reduced depth; the ``_pred`` files
    must be byte-identical."""
    t0 = time.time()
    preds, walls = {}, {}
    preds["cuda"], walls["cuda"] = decode_cli_fp32_run(dev)
    preds["cpu"], walls["cpu"] = ref.result()
    same = preds["cuda"] == preds["cpu"]
    print(f"decode CLI fp32 (2+1 encoder blocks, 1 LLM layer, full width, beam 4, "
          f"{FP32_NEW} new tokens, {sum(DECODE_FP32_UTTS.values())} utterances): _pred files "
          f"{'byte-identical' if same else 'different'} on card and CPU ({len(preds['cpu'])} "
          f"bytes); main {walls['cuda']:.1f} s card, {walls['cpu']:.1f} s CPU "
          f"({time.time() - t0:.1f} s)", flush=True)
    if not same:
        a, b = preds["cuda"].splitlines(), preds["cpu"].splitlines()
        diff = [(x, y) for x, y in zip(a, b) if x != y][:3]
        fail(f"decode CLI fp32: card and CPU _pred files differ, first lines {diff}")


def phase_train_main(torch, dev, model, launches, text_only: bool = False):
    """A training step at full width, bf16, on ``model`` (the serving
    phase's): bench.py's step (phase 5b) or, with ``text_only``, the
    paper's text-only step on the same weights with the flags of
    ``text_only_configs()`` (phase 5d).  TRAIN_WARMUP steps, then
    TRAIN_STEPS timed ones with every kernel's launches counted around
    them, then one profiled step."""
    import statistics

    from ps_slm_tpu_torch.config import (
        BENCH_BATCH, BENCH_FRAMES, BENCH_TEXT_LEN, SENSEVOICE_SMALL, half_audio_configs,
        text_only_configs,
    )
    from ps_slm_tpu_torch.models.tasu import TasuFlags
    from ps_slm_tpu_torch.training.step import make_train_step
    from ps_slm_tpu_torch.utils.flops import tasu_step_flops

    counters = kernel_counters()
    audio_flags = model.flags
    if text_only:
        what, per_step, ln_routes = "text-only path", LAUNCHES_PER_TEXT_ONLY_STEP, LN_ROUTES_TEXT_ONLY
        tc, mc = text_only_configs()       # lr 5e-5, warmup 200, 15000 steps
        model.flags = TasuFlags.from_train_config(tc)
        batch = gt_batch(torch, SENSEVOICE_SMALL["vocab_size"], seed=0)
    else:
        what, per_step, ln_routes = "training path", LAUNCHES_PER_TRAIN_STEP, LN_ROUTES_PER_PASS
        tc, mc = half_audio_configs()      # bench.py: lr 5e-5, warmup 200, 15000 steps
        frames = (BENCH_FRAMES,) * BENCH_BATCH
        batch = train_batch(torch, SENSEVOICE_SMALL["input_size"], frames, seed=0)
        batch["input_features"] = batch["input_features"].to(torch.bfloat16)
    if TEXT_LEN != BENCH_TEXT_LEN:
        fail(f"{what}: the batch's text is not bench.py's")
    step = make_train_step(model, tc)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    t0 = time.perf_counter()
    for _ in range(TRAIN_WARMUP):
        m = step(batch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_counters(counters)
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(m["loss"]))
    for name, fn in counters.items():
        launches[name] = fn.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for name, n in per_step.items():
        if launches[name] != n * TRAIN_STEPS:
            fail(f"{what}: {name} launched {launches[name]} times in {TRAIN_STEPS} "
                 f"steps, expected {n} per step")
    check_routes(counters, launches, what, TRAIN_STEPS, ln_routes)
    if not all(math.isfinite(x) for x in losses):
        fail(f"{what}: non-finite loss {losses}")
    params = dict(model.named_parameters())
    if not all(torch.equal(params[n], p) for n, p in start.items() if n not in step.trainable):
        fail(f"{what}: a frozen weight changed")
    if all(torch.equal(params[n], start[n]) for n in step.trainable):
        fail(f"{what}: the projector did not move")
    del start

    med = statistics.median(times)
    if text_only:
        shape = (f"gt lengths {list(TEXT_ONLY_GT_LENS)} CTC ids, {TEXT_LEN} text tokens, "
                 f"merged length {TEXT_LEN + max(TEXT_ONLY_GT_LENS) - 1}")
        rates = ""
    else:
        shape = (f"{BENCH_BATCH} x {BENCH_FRAMES} frames, {TEXT_LEN} text tokens, "
                 f"merged length {TEXT_LEN + BENCH_FRAMES - 1}")
        fl = tasu_step_flops(model.llm_cfg, model.enc_cfg, mc, batch=BENCH_BATCH,
                             frames=BENCH_FRAMES, text_len=BENCH_TEXT_LEN,
                             freeze_llm=tc.freeze_llm, freeze_encoder=tc.freeze_encoder)
        audio_s = sum(frames) * LFR_FRAME_SEC
        rates = (f"{audio_s / med * 1e3:.1f} audio-sec/s; {fl['total'] / 1e12:.3f} TFLOP/step, "
                 f"{mfu(fl['total'], med, dev)}; ")
    print(f"{'text-only' if text_only else 'train'} main path (bf16, full width, {shape}): "
          f"{TRAIN_WARMUP} warm-up steps {warm_s:.1f} s; {TRAIN_STEPS} steps median "
          f"{med:.2f} ms (min {min(times):.2f}, max {max(times):.2f}; all "
          f"{[round(t, 2) for t in times]}); {rates}losses {losses}; peak memory "
          f"{peak_gb:.2f} GB; frozen weights bit-identical, projector moved; launches per "
          f"step { {k: v // TRAIN_STEPS for k, v in launches.items()} }", flush=True)

    if not text_only:
        psd_time(torch, model, batch, "training batch")
    prof = profiled(torch, lambda: step(batch))
    print_profiled(f"{'text-only ' if text_only else ''}train step", prof)
    model.flags = audio_flags
    return prof


def psd_time(torch, model, batch, label: str) -> None:
    """Device time of one PSD call on the model's CTC posterior for
    ``batch``, from the profiler over PSD_CALLS calls (the call has host
    syncs, so no graph)."""
    from ps_slm_tpu_torch.models.tasu import encode_speech
    from ps_slm_tpu_torch.ops.psd import psd

    dev = next(model.parameters()).device
    with torch.inference_mode():
        _, post, lens = encode_speech(model.encoder, batch["input_features"].to(dev),
                                      batch["input_feature_length"].to(dev))
        def run():
            for _ in range(PSD_CALLS):
                psd(post, lens, post, blank_id=model.enc_cfg.blank_id,
                    blank_threshold=model.flags.blank_threshold)

        run()
        wall, busy, ops, top = profiled(torch, run)
    busy_s = "not measured" if busy is None else f"{busy / PSD_CALLS:.4f} ms"
    print(f"psd ({label}, posterior {list(post.shape)} {post.dtype}): device-busy {busy_s} "
          f"a call in {ops / PSD_CALLS:.0f} device ops, wall {wall / PSD_CALLS:.2f} ms "
          f"({PSD_CALLS} calls); largest {json.dumps(top[:4])}", flush=True)


def launch_counts(counters) -> dict:
    """Every wrapper's launch count, and each norm wrapper's by route as
    ``name.route``."""
    out = {n: f.launches for n, f in counters.items()}
    for name in MAIN_ROUTES:
        out.update({f"{name}.{r}": n for r, n in counters[name].routes.items()})
    return out


def with_routes(per: dict, ln_routes: dict, passes: int = 1, ln_bwd_vec: int = 0) -> dict:
    """``per`` (launches by wrapper) times ``passes``, with the routes the
    main paths take: every RMSNorm vectorised, the LayerNorm forward by
    ``ln_routes`` a pass, and the LayerNorm backward ``ln_bwd_vec`` a pass
    vectorised (the encoder's, the q-former's), the rest wide (the
    projector's)."""
    out = {k: v * passes for k, v in per.items()}
    out.update({f"layer_norm_fwd.{r}": n * passes for r, n in ln_routes.items()})
    out.update({"layer_norm_bwd.vec": ln_bwd_vec * passes,
                "layer_norm_bwd.wide": out["layer_norm_bwd"] - ln_bwd_vec * passes})
    for name in ("rms_norm_fwd", "rms_norm_bwd"):
        out.update({f"{name}.vec": out[name], f"{name}.general": 0})
    return out


def check_step_launches(probe, want: dict, ln_routes: dict, what: str) -> None:
    """Fails unless every micro-step the probe saw launched exactly
    ``want`` (by wrapper; ``ln_routes`` the LayerNorm forward's routes) and
    every validation LAUNCHES_PER_EVAL_BATCH a batch, by route as the
    training steps."""
    want = with_routes(want, ln_routes)
    for i, st in enumerate(probe.steps):
        if st["launches"] != want:
            fail(f"{what}: micro-step {i + 1} launched {st['launches']}, not {want}")
    for ev in probe.evals:
        per = with_routes(LAUNCHES_PER_EVAL_BATCH, ln_routes, ev["batches"])
        if ev["launches"] != per:
            fail(f"{what}: an evaluation of {ev['batches']} batches launched {ev['launches']}, "
                 f"not {per}")


def finetune_cases(torch, dev, model, batch, tag: str) -> dict:
    """Phase 3's cases at one finetune micro-step's batch, labelled ``tag``:
    the LLM's causal GQA attention at B x the merged length with the
    right-padded windows ``prepare_merged`` gives (forward, dq, dk/dv), and
    RMSNorm forward and backward on those rows; the projector's LayerNorm
    forward and backward at 25 055 wide on B x LFR frames of CTC posteriors
    or, for text-only TASU, B x transcript ids of smoothed one-hots; with
    the encoder, its non-causal attention at B x (LFR frames + the 4 query
    frames) with each row's valid prefix, and its LayerNorms (560 and 512
    wide) on those rows.  The dither and masks change no shape, so the
    batch is merged without them; text-only windows are those without the
    CPS noise, whose random drops end the step's rows a few ids earlier."""
    from ps_slm_tpu_torch.models.tasu import QUERY_IDS, prepare_merged
    from ps_slm_tpu_torch.ops import flash_attention as fa
    from ps_slm_tpu_torch.ops.fbank import frontend

    llm, vocab = model.llm.cfg, model.enc_cfg.vocab_size
    with torch.inference_mode():
        mask = prepare_merged(model, batch, generate_mode=True).attention_mask
        rows, s = mask.shape
        start, end = fa.window_from_mask(mask, rows, s, dev)
        flash = [(f"{tag} llm", rows, s, llm.num_attention_heads, llm.num_key_value_heads, True,
                  start.tolist(), end.tolist())]
        cases = {"flash_bwd": list(flash),
                 "norm": [("rms_norm_fwd", rows * s, llm.hidden_size, None)],
                 "norm_bwd": [("rms_norm_bwd", rows * s, llm.hidden_size, None)]}
        if model.flags.needs_encoder:
            feats, flens = frontend(batch["waveform"], batch["waveform_length"],
                                    cfg=model.fbank_cfg)
            frames, q = feats.shape[1], len(QUERY_IDS)
            enc = model.encoder.cfg
            flash.insert(0, (f"{tag} encoder", rows, frames + q, enc.attention_heads,
                             enc.attention_heads, False, [0] * rows, (flens + q).tolist()))
            cases["norm"] += [("layer_norm_fwd", rows * (frames + q), d, None)
                              for d in (enc.input_size, enc.output_size)]
            proj = (rows * frames, None)
        else:
            proj = (batch["gt_ids"].numel(), "mixed")
    cases["flash"] = flash
    cases["norm"].append(("layer_norm_fwd", proj[0], vocab, proj[1]))
    cases["norm_bwd"].insert(0, ("layer_norm_bwd", proj[0], vocab, proj[1]))
    shapes = {k: [c[:5] for c in v] for k, v in cases.items()}
    print(f"finetune chain {tag}: the largest batch's kernel cases for phase 3 (label or "
          f"wrapper, B or rows, S or width, ...) {json.dumps(shapes)}", flush=True)
    return cases


def phase_finetune_chain(torch, dev, launches: dict, step_5b_prof, root: str) -> dict:
    """Phase 7: the published training chain at full widths and depths,
    bf16, through ``cli.finetune.main``: synthetic stand-ins of the assets
    (phase 6's writers, a character BPE model beside the encoder) and train,
    dev and test manifests of 2-12 s utterances, then (7a) the text-only
    recipe's overrides for one epoch, ``save_last``; (7b) the half_audio
    recipe's from 7a's ``last/pytorch_model.bin``, dither on, one epoch with
    validation every CHAIN_VALIDATION steps and step_N checkpoints, then a
    second ``main`` resuming from step_CHAIN_VALIDATION, which must skip
    that many batches and
    reproduce the uninterrupted run's later losses bit for bit; (7c) the
    half_audio step with remat, gradient accumulation 2 and SpecAugment;
    (7d) the decode CLI on 7b's export, clean_marks and WER.  Launches are
    checked exactly per micro-step and per validation batch; frozen weights
    bit-identical.  Writes under ``root`` (the caller deletes it).  Adds
    each stage's launches to ``launches`` (by stage) and returns the
    per-micro-step launches without and with remat, a validation batch's,
    phase 3's cases at 7a's and 7b's largest batches
    (:func:`finetune_cases`, by stage), and for phase 11 the assets, 7a's
    export, the widths and 7b's micro-steps."""
    import statistics

    from ps_slm_tpu_torch.cli import decode, finetune
    from ps_slm_tpu_torch.tools import clean_marks, wer

    what = "finetune chain"
    counters = kernel_counters()
    t0 = time.perf_counter()
    assets, audio, mc = write_chain_assets(torch, root)
    print(f"{what}: assets and manifests written in {time.perf_counter() - t0:.1f} s "
          f"(train {sum(CHAIN_UTTS['train'].values())} utterances, {audio['train']:.2f} s; "
          f"dev {sum(CHAIN_UTTS['dev'].values())}, {audio['dev']:.2f} s; test "
          f"{sum(CHAIN_UTTS['test'].values())}, {assets['audio_seconds']:.2f} s)", flush=True)
    cut = ["++train_config.num_epochs=1"]

    def run(stage, args, profile_at=None):
        torch.cuda.synchronize()
        reset_counters(counters)
        with TrainProbe(torch, dev, profile_at) as probe:
            t = time.perf_counter()
            rc = finetune.main(args)              # default device: cuda
            wall = time.perf_counter() - t
        if rc != 0:
            fail(f"{what} {stage}: main returned {rc}")
        launches[stage] = launch_counts(counters)
        if not all(math.isfinite(x) for x in probe.losses()) or not probe.steps:
            fail(f"{what} {stage}: no steps or a non-finite loss {probe.losses()}")
        return probe, wall

    # 7a: the text-only recipe, then last/
    out_a = os.path.join(root, "exp", "text_only")
    dims = dict(llm_dim=mc.llm_dim, encoder_dim=mc.encoder_dim)
    probe, wall = run("7a", finetune_args(assets, root, out_a, text_only=True, **dims) + cut + [
        "++train_config.save_last=true"])
    check_step_launches(probe, LAUNCHES_PER_TEXT_ONLY_STEP, LN_ROUTES_TEXT_ONLY, f"{what} 7a")
    save = probe.saves[-1]
    cases = {"7a": finetune_cases(torch, dev, probe.model, probe.largest[1], "finetune 7a")}
    probe.model = probe.largest = None
    torch.cuda.empty_cache()
    print(f"{what} 7a (scripts/finetune_text_only.sh, 1 epoch): "
          f"{probe.summary(audio_read=False)}; losses "
          f"{[round(x, 4) for x in probe.losses()]}; last/ train state {save['bytes'] / 1e9:.3f} "
          f"GB written in {save['s']:.2f} s; main {wall:.1f} s", flush=True)
    init = os.path.join(out_a, "last", "pytorch_model.bin")

    # 7b: the half_audio recipe from 7a's export, dither on
    env_b = ["++train_config.validation_interval=%d" % CHAIN_VALIDATION] + cut
    out_b = os.path.join(root, "exp", "half_audio")
    args_b = [a if not a.startswith("ckpt_path=") else f"ckpt_path={init}"
              for a in finetune_args(assets, root, out_b, **dims)] + env_b
    probe_b, wall = run("7b", args_b, profile_at=3)
    model = probe_b.model
    if model.fbank_cfg.dither <= 0 or model.remat:
        fail(f"{what} 7b: dither off or remat on")
    check_step_launches(probe_b, LAUNCHES_PER_TRAIN_STEP, LN_ROUTES_PER_PASS, f"{what} 7b")
    cases["7b"] = finetune_cases(torch, dev, model, probe_b.largest[1], "finetune 7b")
    n_b = len(probe_b.steps)
    tags = sorted(p for p in os.listdir(out_b) if p.startswith("step_"))
    if n_b <= CHAIN_VALIDATION or "step_%d" % CHAIN_VALIDATION not in tags:
        fail(f"{what} 7b: {n_b} steps and checkpoints {tags}; want more than "
             f"{CHAIN_VALIDATION} steps and step_{CHAIN_VALIDATION}")
    ev = probe_b.evals
    print(f"{what} 7b (scripts/finetune_half_audio.sh from 7a's export, dither "
          f"{model.fbank_cfg.dither}, 1 epoch, validation every {CHAIN_VALIDATION}): "
          f"{probe_b.summary()}; losses {[round(x, 4) for x in probe_b.losses()]}; evals "
          f"{[(e['batches'], round(e['loss'], 4), round(e['s'], 3)) for e in ev]} (batches, "
          f"loss, s); checkpoints {tags}, train state "
          f"{[(round(x['bytes'] / 1e9, 3), round(x['s'], 2)) for x in probe_b.saves]} (GB, s "
          f"written); main {wall:.1f} s", flush=True)
    print_profiled(f"{what} 7b loop step (micro-step 4)", probe_b.prof)
    if step_5b_prof is not None:
        print_profiled("for comparison, phase 5b's bench.py step", step_5b_prof)
    del model
    probe_b.model = probe_b.largest = None
    torch.cuda.empty_cache()

    # 7b resumed from its first step_N: skips N batches, reproduces the later losses
    out_r = os.path.join(root, "exp", "half_audio_resumed")
    state = os.path.join(out_b, "step_%d" % CHAIN_VALIDATION, "state")
    args_r = [a.replace(out_b, out_r) for a in args_b] + [f"++train_config.resume_from={state}"]
    probe_r, wall = run("7b resumed", args_r)
    check_step_launches(probe_r, LAUNCHES_PER_TRAIN_STEP, LN_ROUTES_PER_PASS,
                        f"{what} 7b resumed")
    skipped = f"skipping {CHAIN_VALIDATION} trained batches" in read_log(
        os.path.join(out_r, "train.log"))
    want = probe_b.losses()[CHAIN_VALIDATION:]
    got = probe_r.losses()
    same = got == want
    print(f"{what} 7b resumed from step_{CHAIN_VALIDATION}: {probe_r.summary()}; reported "
          f"skipping {CHAIN_VALIDATION} batches {skipped}; fast-forward {probe_r.ff_s:.3f} s; "
          f"restore {probe_r.restores[0]['s']:.2f} s; losses {got} vs uninterrupted {want}: "
          f"{'bit-identical' if same else 'DIFFERENT'}; main {wall:.1f} s [{CARD}]", flush=True)
    if not (skipped and same):
        fail(f"{what} 7b: the resumed run did not skip {CHAIN_VALIDATION} batches or did "
             f"not reproduce the later losses")
    shutil.rmtree(out_r, ignore_errors=True)

    # 7c: remat, gradient accumulation 2, SpecAugment
    out_c = os.path.join(root, "exp", "half_audio_remat")
    args_c = [a.replace(out_b, out_c) for a in args_b] + [
        "++train_config.remat=true", "++train_config.gradient_accumulation_steps=2",
        "++dataset_config.fbank.specaug=true", "++train_config.run_validation=false",
        "++train_config.save_model=false"]
    frozen = {}

    def snapshot(*args, **kwargs):
        step = real_make(*args, **kwargs)
        frozen.update({n: p.detach().cpu().clone() for n, p in step.model.named_parameters()
                       if n not in step.trainable})
        frozen["_step"] = step
        return step

    from ps_slm_tpu_torch.training import step as step_mod

    real_make = step_mod.make_train_step
    step_mod.make_train_step = snapshot
    try:
        probe_c, wall = run("7c", args_c)
    finally:
        step_mod.make_train_step = real_make
    step_c = frozen.pop("_step")
    check_step_launches(probe_c, LAUNCHES_PER_REMAT_STEP, LN_ROUTES_PER_PASS, f"{what} 7c")
    params = dict(step_c.model.named_parameters())
    same_frozen = all(torch.equal(params[n].cpu(), p) for n, p in frozen.items())
    moved = step_c.accum.gradient_step == len(probe_c.steps) // 2
    print(f"{what} 7c (remat, gradient_accumulation_steps 2, SpecAugment): "
          f"{probe_c.summary()}; AdamW updates {step_c.accum.gradient_step} over "
          f"{len(probe_c.steps)} micro-steps; {len(frozen)} frozen tensors "
          f"{'bit-identical' if same_frozen else 'CHANGED'}; peak memory remat off "
          f"{max(s['peak'] for s in probe_b.steps):.2f} GB, on "
          f"{max(s['peak'] for s in probe_c.steps):.2f} GB; main {wall:.1f} s", flush=True)
    if not (same_frozen and moved):
        fail(f"{what} 7c: a frozen weight changed or the updates were not every 2nd micro-step")
    del step_c, params, frozen
    torch.cuda.empty_cache()

    # 7d: decode 7b's export, then clean_marks and WER
    export = os.path.join(out_b, tags[-1], "pytorch_model.bin")
    log = os.path.join(root, "decode", "test")
    args_d = [a if not a.startswith("ckpt_path=") else f"ckpt_path={export}"
              for a in decode_args(assets, log, DECODE_MAX_NEW, **dims)]
    torch.cuda.synchronize()
    reset_counters(counters)
    t = time.perf_counter()
    rc = decode.main(args_d)
    wall = time.perf_counter() - t
    launches["7d"] = launch_counts(counters)
    if rc != 0:
        fail(f"{what} 7d: decode main returned {rc}")
    for path in (log + "_pred", log + "_gt"):
        clean_marks.clean_file(path)
    with open(os.devnull, "w") as null:
        score = wer.score_files(log + "_gt", log + "_pred", stream=null)
    with open(log + "_pred") as f:
        n_pred = sum(1 for line in f if "\t" in line)
    print(f"{what} 7d (cli.decode on 7b's {tags[-1]} export): {n_pred} utterances decoded in "
          f"{wall:.1f} s; WER {score['wer']:.2f}% (random weights: meaningless) [{CARD}]",
          flush=True)
    if n_pred != sum(CHAIN_UTTS["test"].values()):
        fail(f"{what} 7d: {n_pred} utterances decoded")
    shutil.rmtree(out_b, ignore_errors=True)     # 7b's checkpoints: not read again
    return {"step": probe_b.steps[0]["launches"], "remat": probe_c.steps[0]["launches"],
            "eval": {k: v // ev[0]["batches"] for k, v in ev[0]["launches"].items()},
            "cases": cases, "assets": assets, "root": root, "init": init, "dims": dims,
            "steps": n_b, "median_ms": statistics.median(
                s["ms"] for s in probe_b.steps if not s["profiled"])}


def reset_counters(counters) -> None:
    """Every wrapper's launch count, and the norm wrappers' per-route
    counts, to 0."""
    for fn in counters.values():
        fn.launches = 0
        for route in getattr(fn, "routes", {}):
            fn.routes[route] = 0


def check_routes(counters, launches, what: str, passes: int,
                 ln_per_pass=LN_ROUTES_PER_PASS) -> None:
    """Fails unless every RMSNorm launch counted since the reset took the
    vectorised route (the main paths are bf16, 1536 wide), the LayerNorm
    forward's took the routes ``ln_per_pass`` gives (by default the
    vectorised route 142 times and the staged one once) in each of
    ``passes`` generate calls or training steps, and the LayerNorm
    backward's the wide one (the projector's); adds each route's count to
    ``launches`` as ``name.route``."""
    routes = {name: dict(counters[name].routes) for name in MAIN_ROUTES}
    print(f"{what}: norm routes {routes}", flush=True)
    for name, r in routes.items():
        want = ({k: v * passes for k, v in ln_per_pass.items()} if name == "layer_norm_fwd"
                else {"vec": 0, "wide": launches[name]} if name == "layer_norm_bwd"
                else {"vec": launches[name], "general": 0})
        if r != want:
            fail(f"{what}: {name} launched {launches[name]} times, by route {r}, not {want}")
        launches.update({f"{name}.{k}": v for k, v in r.items()})


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by name: each carries ``.launches``."""
    from ps_slm_tpu_torch.ops import flash_attention as fa
    from ps_slm_tpu_torch.ops import norms

    return {
        "flash_attention_fwd": fa.flash_attention_fwd,
        "flash_attention_dq": fa.flash_attention_dq,
        "flash_attention_dkv": fa.flash_attention_dkv,
        "layer_norm_fwd": norms.layer_norm_fwd,
        "layer_norm_bwd": norms.layer_norm_bwd,
        "rms_norm_fwd": norms.rms_norm_fwd,
        "rms_norm_bwd": norms.rms_norm_bwd,
    }


def phase_main(torch, dev, launches, model=None, beam: bool = False):
    """The serving main path at full width, bf16: ``generate`` on the
    serving batch, greedy (phase 5, which builds the model) or, with
    ``beam``, with the default beams (4) on phase 5's ``model`` (phase 5c).  Launches, decode
    steps and two calls' bit-identical tokens checked; timed, then
    profiled.  Returns the model."""
    from ps_slm_tpu_torch.config import QWEN25_1_5B, SENSEVOICE_SMALL, half_audio_configs
    from ps_slm_tpu_torch.inference.generate import _prefill, generate
    from ps_slm_tpu_torch.models.tasu import model_factory, prepare_merged

    counters = kernel_counters()
    what = "beam path (num_beams 4, the default)" if beam else "main path"
    if model is None:
        tc, mc = half_audio_configs()
        t0 = time.time()
        model = model_factory(tc, mc, dtype=torch.bfloat16)   # default device: cuda
        model.speech_token_id = SPEECH_TOKEN
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        print(f"main path: {n_params / 1e9:.3f} B parameters, bf16, init "
              f"{time.time() - t0:.1f} s", flush=True)
    batch = serving_batch(torch, SENSEVOICE_SMALL["input_size"])
    batch["input_features"] = batch["input_features"].to(torch.bfloat16)

    def run(max_new):
        return generate(model, batch, eos_token_id=EOS, max_new_tokens=max_new,
                        **({} if beam else {"num_beams": 1}))

    run(2)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(counters)
    with counting_steps() as step_starts:
        t0 = time.perf_counter()
        tokens = run(MAX_NEW)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    for name, fn in counters.items():
        launches[name] = fn.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    steps = len(step_starts)
    if tokens.shape != (len(FRAMES), MAX_NEW) or not bool(
            ((tokens >= 0) & (tokens < QWEN25_1_5B["vocab_size"])).all()):
        fail(f"{what}: bad tokens {tuple(tokens.shape)}")
    tokens = tokens.cpu()
    # the beam loop has no early exit; greedy stops once every row is done
    want_steps = MAX_NEW - 1 if beam else loop_steps(tokens, MAX_NEW)
    if steps != want_steps:
        fail(f"{what}: {steps} decode steps, not {want_steps}")
    need = {name: 0 for name in counters}
    need.update({"flash_attention_fwd": FLASH_PER_GENERATE, "layer_norm_fwd": LN_PER_GENERATE,
                 "rms_norm_fwd": RMS_PER_FORWARD * (1 + steps)})
    for name, n in need.items():
        if launches[name] != n:
            fail(f"{what}: {name} launched {launches[name]} times, expected {n}")
    check_routes(counters, launches, what, 1)
    same = torch.equal(tokens, run(MAX_NEW).cpu())

    total_ms = (t_end - t0) * 1e3
    first_ms = (step_starts[0] - t0) * 1e3 if steps else total_ms
    step_ms = (t_end - step_starts[0]) * 1e3 / steps if steps else 0.0
    audio_s = sum(FRAMES) * LFR_FRAME_SEC
    n_tok = real_tokens(tokens, steps)
    first = "front half + LLM prefill" + (" + first top-k" if beam else "")
    print(f"{what}: generate {total_ms:.1f} ms = first token {first_ms:.1f} ms ({first}) + "
          f"{steps} decode steps x {step_ms:.2f} ms; {audio_s / total_ms * 1e3:.1f} "
          f"audio-sec/s, {n_tok} tokens generated, {n_tok / total_ms * 1e3:.1f} tokens/s; "
          f"peak memory {peak_gb:.2f} GB; two calls give "
          f"{'bit-identical' if same else 'different'} tokens; launches {launches}"
          + (f"; tokens {tokens.tolist()}" if beam else ""), flush=True)
    if not same:
        fail(f"{what}: two generate calls on the same batch give different tokens")

    if not beam:
        # the first token's split, from a separately timed run
        bd = {k: v.to(dev) for k, v in batch.items()}
        with torch.inference_mode():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            merged = prepare_merged(model, bd, left_padding=True)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            logits, _, _ = _prefill(model.llm, merged.embeds, merged.attention_mask,
                                    merged.position_ids, merged.embeds.shape[1] + MAX_NEW)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
        if not bool(torch.isfinite(logits).all()) or not bool(
                torch.isfinite(merged.embeds.float()).all()):
            fail("main path: non-finite merged embeddings or prefill logits")
        print(f"main path, split run: merged length {merged.embeds.shape[1]}, valid merged "
              f"lengths {merged.attention_mask.sum(1).tolist()}; front half "
              f"{(t2 - t1) * 1e3:.1f} ms, LLM prefill {(t3 - t2) * 1e3:.1f} ms", flush=True)
        # the front half (encoder, PSD's segment sums, projector, merge)
        # gives the same bits on every call
        with torch.inference_mode():
            again = prepare_merged(model, bd, left_padding=True)
        same = all(torch.equal(a, b) for a, b in zip(
            (merged.embeds, merged.attention_mask, merged.position_ids),
            (again.embeds, again.attention_mask, again.position_ids)))
        print(f"main path: two prepare_merged calls give "
              f"{'bit-identical' if same else 'different'} embeddings", flush=True)
        if not same:
            fail("main path: two prepare_merged calls on the same batch differ")
        psd_time(torch, model, bd, "serving batch")

    # device-busy share: generate with no decode step, then the whole
    # call, each under the profiler with its own wall time
    label = "beam " if beam else ""
    with counting_steps() as prof_steps:
        first = profiled(torch, lambda: run(1))
        whole = profiled(torch, lambda: run(MAX_NEW))
    print_profiled(f"{label}first token", first)
    print_profiled(f"{label}whole generate", whole)
    n = len(prof_steps)
    if n and first[1] is not None and whole[1] is not None:
        d_wall, d_busy = whole[0] - first[0], whole[1] - first[1]
        print(f"profiled {label}decode ({n} steps, whole - first token): {d_wall / n:.2f} ms "
              f"wall, {d_busy / n:.3f} ms device-busy, {(whole[2] - first[2]) / n:.0f} device "
              f"ops per step; busy share {d_busy / d_wall:.3f}", flush=True)
    return model


def batch_shapes(batch, fbank_cfg) -> tuple:
    """(rows, LFR frames, merged length) of a CLI batch: the waveform's
    padded samples framed as the front end frames them; the merge's static
    length is the prompt's plus the (PSD-padded) audio's, less the speech
    token."""
    rows, n = batch["waveform"].shape
    sr = fbank_cfg.sample_rate
    frame_len, shift = sr * fbank_cfg.frame_length // 1000, sr * fbank_cfg.frame_shift // 1000
    lfr = -(-max(1 + (n - frame_len) // shift, 0) // fbank_cfg.lfr_n)
    return rows, lfr, batch["input_ids"].shape[1] + lfr - 1


def phase_decode_cli(torch, dev, launches, root=None) -> tuple:
    """Phase 6: scripts/decode.sh through the port's decode CLI at the
    published widths and depths, bf16: synthetic stand-ins of its assets
    written from a seeded model (:func:`write_assets`), then
    ``cli.decode.main`` with the recipe's overrides (``DECODE_MAX_NEW``
    new tokens), then the port's clean_marks and WER on its files.  Fails
    unless every utterance is decoded once, the loaded weights equal the
    written ones cast to bf16 bit for bit, every parameter and the CMVN are
    on the card, each batch launches exactly its kernels by route, the
    first batch decodes to the same tokens again, and the front end on the
    card is within FRONTEND_TOL of the CPU's in fp32.  Adds the launches
    summed over the batches to ``launches`` and returns (launches per batch,
    the largest batch's flash and norm cases for phase 3, the assets).
    With ``root`` the assets are written there and left for the caller."""
    import shutil
    import tempfile

    from ps_slm_tpu_torch import registry
    from ps_slm_tpu_torch.cli import decode
    from ps_slm_tpu_torch.config import half_audio_configs
    from ps_slm_tpu_torch.data import audio_io
    from ps_slm_tpu_torch.models.qwen2 import hf_to_state_dict
    from ps_slm_tpu_torch.models.tasu import model_factory, prepare_merged
    from ps_slm_tpu_torch.ops.fbank import frontend
    from ps_slm_tpu_torch.tools import clean_marks, wer
    from ps_slm_tpu_torch.training import checkpoint as ckpt

    what = "decode CLI"
    counters = kernel_counters()
    own = root is None
    root = root or tempfile.mkdtemp(prefix="decode_cli_")
    try:
        t0 = time.perf_counter()
        tc, mc = half_audio_configs()
        src = model_factory(tc, mc)                  # fp32 on the card, seed 42
        assets = write_assets(root, src, llm_dtype=torch.bfloat16)
        del src
        torch.cuda.empty_cache()
        sizes = {k: sum(os.path.getsize(os.path.join(assets[f"{k}_path"], f))
                        for f in os.listdir(assets[f"{k}_path"])) / 1e9
                 for k in ("llm", "encoder")}
        sizes["ckpt"] = os.path.getsize(assets["ckpt_path"]) / 1e9
        print(f"{what}: assets written in {time.perf_counter() - t0:.1f} s (Qwen2.5 dir "
              f"{sizes['llm']:.2f} GB bf16 safetensors, SenseVoiceSmall dir "
              f"{sizes['encoder']:.2f} GB fp32 model.pt, projector checkpoint "
              f"{sizes['ckpt']:.2f} GB; {sum(DECODE_UTTS.values())} utterances {DECODE_UTTS}, "
              f"{assets['audio_seconds']:.2f} s of audio)", flush=True)

        # hooks around the CLI: the model its factory builds, the checkpoint
        # import's seconds, and each batch's generate call with its launches
        seen: dict = {"batches": []}
        real_factory = registry.get_model_factory("tasu")
        real_import = ckpt.import_reference_checkpoint
        real_generate = decode.generate

        def factory(*args, **kwargs):
            seen["model"] = real_factory(*args, **kwargs)
            return seen["model"]

        def timed_import(*args, **kwargs):
            t = time.perf_counter()
            out = real_import(*args, **kwargs)
            torch.cuda.synchronize()
            seen["ckpt_s"] = time.perf_counter() - t
            return out

        def counted_generate(model, batch, **kwargs):
            torch.cuda.synchronize()
            reset_counters(counters)
            with counting_steps() as steps:
                t = time.perf_counter()
                out = real_generate(model, batch, **kwargs)
                torch.cuda.synchronize()
                t_end = time.perf_counter()
            seen["batches"].append(dict(
                ms=(t_end - t) * 1e3, first_ms=(steps[0] - t) * 1e3 if steps else None,
                step_ms=(t_end - steps[0]) * 1e3 / len(steps) if steps else None,
                steps=len(steps), batch=batch, kwargs=kwargs, tokens=out.cpu(),
                launches={n: f.launches for n, f in counters.items()},
                routes={n: dict(counters[n].routes) for n in MAIN_ROUTES}))
            return out

        log = os.path.join(root, "decode", "test")
        registry.register_model("tasu")(factory)
        ckpt.import_reference_checkpoint = timed_import
        decode.generate = counted_generate
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            rc = decode.main(decode_args(assets, log, DECODE_MAX_NEW, mc.llm_dim,
                                         mc.encoder_dim))          # default device: cuda
        finally:
            registry.register_model("tasu")(real_factory)
            ckpt.import_reference_checkpoint = real_import
            decode.generate = real_generate
        main_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if rc != 0:
            fail(f"{what}: main returned {rc}")
        model, batches = seen["model"], seen["batches"]

        # every utterance once in each file
        with open(os.path.join(assets["data"], "multitask.jsonl")) as f:
            keys = [json.loads(line)["key"] for line in f]
        for suffix in ("_pred", "_gt"):
            with open(log + suffix, encoding="utf-8") as f:
                got = [line.split("\t", 1)[0] for line in f.read().split("\n") if "\t" in line]
            if sorted(got) != sorted(keys):
                fail(f"{what}: {suffix} holds keys {sorted(got)}, not each of {sorted(keys)} once")

        # the loaded weights: the written tensors cast once to the model's dtype
        dt = model.llm.embed_tokens.weight.dtype
        written = {
            "llm": hf_to_state_dict(assets["llm"], model.llm.cfg),
            "encoder": ckpt.funasr_to_state_dict(assets["encoder"], model.encoder.cfg),
            "projector": ckpt.reference_to_projector(assets["projector"], "linear-silu")[0],
        }
        n_cmp = 0
        for part, state in written.items():
            have = getattr(model, part).state_dict()
            if sorted(have) != sorted(state):
                fail(f"{what}: the {part}'s parameters are not the written tensors' names")
            for k, v in state.items():
                n_cmp += 1
                if not torch.equal(have[k].cpu(), v.to(dt)):
                    fail(f"{what}: {part}.{k} differs from the written tensor cast to {dt}")
        on_card = all(p.device.type == dev.type for p in model.parameters()) and \
            model.cmvn is not None and all(c.device.type == dev.type for c in model.cmvn)
        if not on_card or dt != torch.bfloat16:
            fail(f"{what}: a parameter or the CMVN is off the card, or the model is {dt}")
        native = audio_io.native_available()
        print(f"{what}: loaded Qwen2.5 safetensors in {model.load_seconds['llm']:.2f} s, "
              f"SenseVoiceSmall model.pt in {model.load_seconds['encoder']:.2f} s, the "
              f"reference checkpoint in {seen['ckpt_s']:.2f} s; {n_cmp} tensors bit-equal to "
              f"the written ones cast to {dt}; every parameter and the CMVN on {dev}; audio read "
              f"by {'the native C++ helper' if native else 'pure Python (no native/build)'}",
              flush=True)

        # launches per batch, by route
        want = {name: 0 for name in counters}
        want.update({"flash_attention_fwd": FLASH_PER_GENERATE, "layer_norm_fwd": LN_PER_GENERATE,
                     "rms_norm_fwd": RMS_PER_FORWARD * DECODE_MAX_NEW})
        want_routes = {"layer_norm_fwd": LN_ROUTES_PER_PASS,
                       "rms_norm_fwd": {"vec": RMS_PER_FORWARD * DECODE_MAX_NEW, "general": 0},
                       "rms_norm_bwd": {"vec": 0, "general": 0},
                       "layer_norm_bwd": {"vec": 0, "wide": 0}}
        gen_ms = 0.0
        for i, rec in enumerate(batches):
            rows, frames, merged = batch_shapes(rec["batch"], model.fbank_cfg)
            gen_ms += rec["ms"]
            audio = float(rec["batch"]["waveform_length"].sum()) / 16000
            print(f"{what} batch {i}: {rows} rows ({4 * rows} beam rows), {frames} LFR frames, "
                  f"merged length {merged}, {audio:.2f} s of audio; generate {rec['ms']:.1f} ms "
                  f"= first token {rec['first_ms']:.1f} ms + {rec['steps']} beam steps x "
                  f"{rec['step_ms']:.2f} ms; launches {rec['launches']}, routes {rec['routes']}",
                  flush=True)
            if rec["steps"] != DECODE_MAX_NEW - 1:
                fail(f"{what} batch {i}: {rec['steps']} beam steps, not {DECODE_MAX_NEW - 1}")
            if rec["launches"] != want or rec["routes"] != want_routes:
                fail(f"{what} batch {i}: launches {rec['launches']} by route {rec['routes']}, "
                     f"not {want} by {want_routes}")
        for name in counters:
            launches[name] = sum(rec["launches"][name] for rec in batches)
        for name in MAIN_ROUTES:
            for route in counters[name].routes:
                launches[f"{name}.{route}"] = sum(rec["routes"][name][route] for rec in batches)

        # the first batch again: bit-identical tokens
        first = batches[0]
        again = real_generate(model, first["batch"], **first["kwargs"]).cpu()
        if not torch.equal(again, first["tokens"]):
            fail(f"{what}: re-decoding the first batch gives other tokens")

        # the front end, fp32, card vs CPU, on the first batch
        wav, wlen = first["batch"]["waveform"], first["batch"]["waveform_length"]
        cpu_cmvn = tuple(c.cpu() for c in model.cmvn)
        f_cpu, l_cpu = frontend(wav, wlen, cfg=model.fbank_cfg, cmvn=cpu_cmvn)
        f_gpu, l_gpu = frontend(wav.to(dev), wlen.to(dev), cfg=model.fbank_cfg, cmvn=model.cmvn)
        fe_err = float((f_gpu.cpu() - f_cpu).abs().max())
        if not torch.equal(l_gpu.cpu(), l_cpu) or not fe_err <= FRONTEND_TOL:
            fail(f"{what}: the front end on the card is {fe_err:.3e} from the CPU's")
        fe_prof = profiled(torch, lambda: frontend(wav.to(dev), wlen.to(dev), cfg=model.fbank_cfg,
                                                   cmvn=model.cmvn))
        gen_prof = profiled(torch, lambda: real_generate(model, first["batch"], **first["kwargs"]))

        # the CLI's own throughput line, and the scoring
        with open(log + ".log") as f:
            done = [line.strip() for line in f if "decode done" in line]
        for path in (log + "_pred", log + "_gt"):
            clean_marks.clean_file(path)
        with open(os.devnull, "w") as null:
            score = wer.score_files(log + "_gt", log + "_pred", stream=null)
        host = {}
        with open(os.path.join(assets["data"], "multitask.jsonl")) as f:
            for row in map(json.loads, f):
                kind = "ark" if ".ark:" in row["path"] else row["path"].rsplit(".", 1)[1]
                t = time.perf_counter()
                audio_io.load_audio(row["path"])
                host[kind] = host.get(kind, 0.0) + time.perf_counter() - t
        print(f"{what}: the CLI logs {done[-1].split(' - ', 1)[-1] if done else 'nothing'}; "
              f"main {main_s:.2f} s wall, generate {gen_ms / 1e3:.2f} s of it, "
              f"{1 - gen_ms / 1e3 / main_s:.3f} outside generate (loading, the manifest, audio "
              f"reads, tokenizing, batching, detokenizing, writing); audio reads alone "
              f"{json.dumps({k: round(v, 3) for k, v in host.items()})} s by kind; "
              f"{assets['audio_seconds'] / (gen_ms / 1e3):.1f} audio-s/s in generate, "
              f"{assets['audio_seconds'] / main_s:.1f} over main; peak memory {peak_gb:.2f} GB; "
              f"front end fp32 card vs CPU {fe_err:.3e} (tol {FRONTEND_TOL}); first batch "
              f"re-decoded bit-identical; WER {score['wer']:.2f}% (random weights: meaningless)",
              flush=True)
        print_profiled(f"{what} front end, first batch", fe_prof)
        print_profiled(f"{what} generate, first batch", gen_prof)

        # the largest batch's shapes for phase 3
        big = max(batches, key=lambda rec: batch_shapes(rec["batch"], model.fbank_cfg)[0]
                  * batch_shapes(rec["batch"], model.fbank_cfg)[2])
        rows, frames, merged = batch_shapes(big["batch"], model.fbank_cfg)
        bd = {k: v.to(dev) for k, v in big["batch"].items()}
        with torch.inference_mode():
            _, flens = frontend(bd["waveform"], bd["waveform_length"], cfg=model.fbank_cfg)
            valid = prepare_merged(model, bd, left_padding=True, generate_mode=True
                                   ).attention_mask.sum(1)
        s_enc = frames + 4
        flash = (("decode_cli encoder", rows, s_enc, 4, 4, False, [0] * rows,
                  (flens + 4).tolist()),
                 ("decode_cli prefill", rows, merged, 12, 2, True, (merged - valid).tolist(),
                  [merged] * rows))
        norm = (("layer_norm_fwd", rows * s_enc, 560, None),
                ("layer_norm_fwd", rows * s_enc, 512, None),
                ("layer_norm_fwd", rows * frames, 25055, None),
                ("rms_norm_fwd", rows * merged, 1536, None),
                ("rms_norm_fwd", 4 * rows, 1536, None))
        per_batch = dict(batches[0]["launches"])
        for name, routes in batches[0]["routes"].items():
            per_batch.update({f"{name}.{route}": n for route, n in routes.items()})
        return per_batch, flash, norm, assets
    finally:
        if own:
            shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 8: the serving recipe, scripts/decode_serving.sh
# ---------------------------------------------------------------------------

LLM_LAYERS = 28
ENC_FLASH = FLASH_PER_GENERATE - LLM_LAYERS   # flash launches of one front half (70 blocks)
SERVE_FP32_UTTS = {"ark": 2, "wav": 1, "flac": 1}
# 8a: fp32, 3 slots for 4 utterances (so a slot is refilled), a 512-frame
# pool bucket (the merged prefills are under 300 long) to keep the CPU runs short
SERVE_FP32_ARGS = ["++train_config.mixed_precision=false", "++train_config.decode_slots=3",
                   "++dataset_config.eval_max_frame_length=512"]
# (label, the script's MODE, overrides after the script's, run on the CPU too)
SERVE_FP32_MODES = (
    ("plain", "plain", [], True),
    ("speculative", "speculative", [], True),
    # the pools' CPU runs: phase 10a runs them card vs CPU through cli.serve
    ("continuous", "continuous", [], False),
    ("continuous+speculative", "continuous", ["++train_config.speculative_ctc=true"], False),
    ("continuous beam-4", "continuous", ["++train_config.num_beams=4"], False),
    ("static beam-4", "plain", ["++train_config.num_beams=4"], False),
    ("quant_bits=4", "plain", ["++train_config.quant_bits=4"], True),
    ("kv_cache_bits=8", "plain", ["++train_config.kv_cache_bits=8"], True),
)
# on the card, these modes' _pred must equal the named mode's
SERVE_SAME = {"speculative": "plain", "continuous": "plain", "continuous+speculative": "plain",
              "continuous beam-4": "static beam-4"}
# 8b: (label, MODE, overrides, int8 weights as the script sets them)
SERVE_RUNS = (
    ("continuous", "continuous", [], True),
    ("speculative", "speculative", [], True),
    ("plain", "plain", [], True),
    ("plain bf16", "plain", [], False),
    ("continuous kv8", "continuous", ["++train_config.kv_cache_bits=8"], True),
)
POOL_CAPS = (4, 32)     # 8c: stop_after caps drawn from this range


def read_pred(path: str) -> dict:
    """{key: text} of a ``_pred`` or ``_gt`` file; fails on a repeated key."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f.read().split("\n"):
            if "\t" in line:
                key, text = line.split("\t", 1)
                if key in out:
                    fail(f"{path}: {key} appears twice")
                out[key] = text
    return out


@contextlib.contextmanager
def recorded_tokens():
    """Record the ids of every text the decode CLI writes (the byte-level
    tokenizer's ``decode``, which ``batch_decode`` calls row by row), each
    cut at its first EOS, in call order: the synthetic tokenizer decodes
    only its 256 byte tokens to text, so the files alone hide most ids."""
    from ps_slm_tpu_torch.data import tokenizer

    calls: list = []
    real = tokenizer.OwnBPETokenizer.decode

    def decode(self, ids, skip_special_tokens: bool = True):
        row = [int(i) for i in ids]
        calls.append(row[:row.index(self.eos_token_id)] if self.eos_token_id in row else row)
        return real(self, ids, skip_special_tokens)

    tokenizer.OwnBPETokenizer.decode = decode
    try:
        yield calls
    finally:
        tokenizer.OwnBPETokenizer.decode = real


def tokens_by_key(pred_path: str, calls: list, what: str) -> dict:
    """{key: ids} from a ``_pred`` file's keys, in file order, and the
    decodes recorded while it was written (one a line)."""
    keys = list(read_pred(pred_path))
    if len(keys) != len(calls):
        fail(f"{what}: {len(calls)} decodes recorded for {len(keys)} lines")
    return dict(zip(keys, map(tuple, calls)))


def serving_fp32_run(device) -> tuple:
    """Phase 8a's decode CLI runs on ``device`` (every mode on the card,
    those marked for it on the CPU), on its own copy of the assets in a
    temporary directory (deleted after): by mode label the ``_pred`` lines
    sorted, the token ids by key and ``main``'s wall seconds."""
    import torch

    from ps_slm_tpu_torch.cli import decode
    from ps_slm_tpu_torch.config import half_audio_configs
    from ps_slm_tpu_torch.models.tasu import model_factory

    name = torch.device(device).type
    preds, walls, toks = {}, {}, {}
    root = tempfile.mkdtemp(prefix="serving_fp32_")
    try:
        tc, mc = half_audio_configs(*FP32_DEPTH_LAYERED, seed=0)
        assets = write_assets(root, model_factory(tc, mc, device="cpu"),
                              llm_dtype=torch.bfloat16, utts=SERVE_FP32_UTTS)
        write_bpe_model(assets["encoder_path"], vocab=mc.encoder_dim)
        for label, mode, extra, on_cpu in SERVE_FP32_MODES:
            if name == "cpu" and not on_cpu:
                continue
            log = os.path.join(root, name, label.replace(" ", "_"), "test")
            args = serving_args(assets, mode, log, FP32_NEW, mc.llm_dim, mc.encoder_dim)
            t1 = time.time()
            with recorded_tokens() as calls:
                if decode.main(args + SERVE_FP32_ARGS + extra, device=device) != 0:
                    fail(f"serving fp32 {label} on {name}: main returned nonzero")
            walls[label] = time.time() - t1
            with open(log + "_pred", "rb") as f:
                # the pools write in completion order: compare the lines sorted
                preds[label] = b"\n".join(sorted(f.read().split(b"\n")))
            toks[label] = tokens_by_key(log + "_pred", calls, f"serving fp32 {label}")
            if sorted(read_pred(log + "_pred")) != sorted(read_pred(log + "_gt")):
                fail(f"serving fp32 {label} on {name}: _pred and _gt hold other keys")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return preds, toks, walls


def phase_serving_fp32(torch, dev, cpu_ref) -> None:
    """Phase 8a: scripts/decode_serving.sh's modes through ``cli.decode.main``
    in fp32 at full width and reduced depth (2+1 encoder blocks, 2 LLM
    layers), on the card (:func:`serving_fp32_run`) against ``cpu_ref``,
    the CPU's run of the modes without a pool (phase 10a runs the pools card
    vs CPU), each with the script's ``quantization=true``.  The card's
    ``_pred`` must be byte-identical to the CPU's in every mode run on
    both, and on the card the pool and speculative modes' to plain
    greedy's (the beam pool's to static beam-4's), its lines sorted (the
    pools write in completion order)."""
    t0 = time.time()
    preds, walls, toks = {}, {}, {}
    for name, run in (("cuda", lambda: serving_fp32_run(dev)), ("cpu", cpu_ref.result)):
        p, t, w = run()
        for label in p:
            preds[label, name], toks[label, name], walls[label, name] = p[label], t[label], w[label]
    n = sum(SERVE_FP32_UTTS.values())

    def same(a, b) -> bool:
        return preds[a] == preds[b] and toks[a] == toks[b]

    for label, _, _, on_cpu in SERVE_FP32_MODES:
        same_cpu = "CPU not run" if not on_cpu else (
            "identical to the CPU's" if same((label, "cuda"), (label, "cpu"))
            else "DIFFERENT from the CPU's")
        ref = SERVE_SAME.get(label)
        same_ref = "" if ref is None else (
            f", {'identical to' if same((label, 'cuda'), (ref, 'cuda')) else 'DIFFERENT from'} "
            f"{ref}'s on the card")
        cpu_wall = f", {walls[label, 'cpu']:.1f} s CPU" if on_cpu else ""
        n_tok = sum(map(len, toks[label, "cuda"].values()))
        print(f"serving fp32 {label} (2+1 encoder blocks, 1 LLM layer, full width, quantized, "
              f"{FP32_NEW} new tokens, {n} utterances): _pred bytes and token ids {same_cpu}"
              f"{same_ref} ({len(preds[label, 'cuda'])} bytes, {n_tok} tokens); main "
              f"{walls[label, 'cuda']:.1f} s card{cpu_wall}", flush=True)
    for label, _, _, on_cpu in SERVE_FP32_MODES:
        if on_cpu and not same((label, "cuda"), (label, "cpu")):
            fail(f"serving fp32 {label}: the card's _pred or tokens differ from the CPU's")
        ref = SERVE_SAME.get(label)
        if ref and not same((label, "cuda"), (ref, "cuda")):
            fail(f"serving fp32 {label}: the card's _pred or tokens differ from {ref}'s")
    print(f"serving fp32: {time.time() - t0:.1f} s", flush=True)


@contextlib.contextmanager
def serving_hooks(torch):
    """Record, while the decode CLI runs: the model its factory builds and
    the factory's and checkpoint import's seconds, the largest KV cache
    allocated (bytes), and the speculative loop's forwards (with rows)."""
    from ps_slm_tpu_torch import registry
    from ps_slm_tpu_torch.inference import (
        continuous, continuous_beam, continuous_spec, generate, speculative,
    )
    from ps_slm_tpu_torch.models import qwen2
    from ps_slm_tpu_torch.training import checkpoint as ckpt

    seen = {"kv_bytes": 0, "forwards": [], "load_s": 0.0}
    real_factory = registry.get_model_factory("tasu")
    real_import = ckpt.import_reference_checkpoint
    real_spec = speculative.speculative_greedy_generate

    def factory(*args, **kwargs):
        t = time.perf_counter()
        seen["model"] = real_factory(*args, **kwargs)
        seen["load_s"] += time.perf_counter() - t
        return seen["model"]

    def timed_import(*args, **kwargs):
        t = time.perf_counter()
        out = real_import(*args, **kwargs)
        torch.cuda.synchronize()
        seen["load_s"] += time.perf_counter() - t
        return out

    def cache(*args, **kwargs):
        out = qwen2.init_cache(*args, **kwargs)
        seen["kv_bytes"] = max(seen["kv_bytes"], sum(t.nbytes for layer in out for t in layer))
        return out

    def spec(llm, embeds, *args, **kwargs):
        out, n_fwd = real_spec(llm, embeds, *args, **kwargs)
        seen["forwards"].append((n_fwd, embeds.shape[0]))
        return out, n_fwd

    mods = (continuous, continuous_beam, continuous_spec, generate, speculative)
    registry.register_model("tasu")(factory)
    ckpt.import_reference_checkpoint = timed_import
    speculative.speculative_greedy_generate = spec
    for m in mods:
        m.init_cache = cache
    try:
        yield seen
    finally:
        registry.register_model("tasu")(real_factory)
        ckpt.import_reference_checkpoint = real_import
        speculative.speculative_greedy_generate = real_spec
        for m in mods:
            m.init_cache = qwen2.init_cache


def llm_bytes(llm) -> tuple:
    """(all bytes of the LLM's parameters and buffers, the bytes of its
    projection weights or codes)."""
    from ps_slm_tpu_torch.models.quantization import QUANT_TARGETS

    total = sum(t.nbytes for t in list(llm.parameters()) + list(llm.buffers()))
    proj = sum(t.nbytes for layer in llm.layers for name in QUANT_TARGETS
               for leaf, t in getattr(layer, name).named_parameters(recurse=False) if leaf == "weight")
    proj += sum(t.nbytes for layer in llm.layers for name in QUANT_TARGETS
                for leaf, t in getattr(layer, name).named_buffers() if leaf in ("q8", "q4"))
    return total, proj


def phase_serving(torch, dev, launches, assets) -> dict:
    """Phase 8b: scripts/decode_serving.sh through the port's decode CLI at
    full size, bf16, on phase 6's synthetic assets (32 utterances of 2-12 s,
    DECODE_MAX_NEW new tokens instead of 200): MODE=continuous, speculative
    and plain as the script passes them (int8 weights), plain with a bf16
    LLM to compare against, and continuous with the int8 KV cache.  Fails
    unless every utterance is answered once in each file, the int8 LLM's
    weights take at most 0.6x the bf16 LLM's bytes, and every run launches
    the serving path's kernels, the norms on their main routes.  Adds the
    launches to ``launches`` and returns the continuous run's model."""
    from ps_slm_tpu_torch.cli import decode
    from ps_slm_tpu_torch.config import half_audio_configs

    what = "serving"
    counters = kernel_counters()
    _, mc = half_audio_configs()
    write_bpe_model(assets["encoder_path"], vocab=mc.encoder_dim)
    with open(os.path.join(assets["data"], "multitask.jsonl")) as f:
        keys = sorted(json.loads(line)["key"] for line in f)
    preds, out = {}, {}
    for name in counters:
        launches.setdefault(name, 0)
    for label, mode, extra, quantized in SERVE_RUNS:
        log = os.path.join(os.path.dirname(assets["data"]), "serving", label.replace(" ", "_"),
                           "test")
        args = serving_args(assets, mode, log, DECODE_MAX_NEW, mc.llm_dim, mc.encoder_dim) + extra
        if not quantized:
            args.remove("++train_config.quantization=true")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counters(counters)
        held_gb = torch.cuda.memory_allocated() / 1e9
        with serving_hooks(torch) as seen, recorded_tokens() as calls:
            t0 = time.perf_counter()
            if decode.main(args) != 0:                 # default device: cuda
                fail(f"{what} {label}: main returned nonzero")
            wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        run = {n: f.launches for n, f in counters.items()}
        routes = {n: dict(counters[n].routes) for n in MAIN_ROUTES}
        for n, c in run.items():
            launches[n] += c
        for n, r in routes.items():
            for route, c in r.items():
                launches[f"{n}.{route}"] = launches.get(f"{n}.{route}", 0) + c
        if not (run["flash_attention_fwd"] and routes["layer_norm_fwd"]["vec"]
                and routes["layer_norm_fwd"]["staged"] and run["rms_norm_fwd"]):
            fail(f"{what} {label}: a serving-path kernel was not launched: {run} {routes}")
        if routes["rms_norm_fwd"]["general"] or routes["layer_norm_fwd"]["general"] \
                or routes["layer_norm_fwd"]["held"]:
            fail(f"{what} {label}: a norm left its main route: {routes}")
        for suffix in ("_pred", "_gt"):
            if sorted(read_pred(log + suffix)) != keys:
                fail(f"{what} {label}: {suffix} does not hold each utterance once")
        preds[label] = tokens_by_key(log + "_pred", calls, f"{what} {label}")
        with open(log + ".log") as f:
            done = [line.strip().split(" - ", 1)[-1] for line in f if "decode done" in line]
        model = seen["model"]
        total_b, proj_b = llm_bytes(model.llm)
        decode_s = wall - seen["load_s"]
        spec = ""
        if seen["forwards"]:
            fwd = sum(n for n, _ in seen["forwards"])
            spec = (f"; speculative: {fwd} LLM forwards over {len(seen['forwards'])} batches "
                    f"({[n for n, _ in seen['forwards']]}; plain greedy takes up to "
                    f"{DECODE_MAX_NEW} a batch), one host sync each")
        out[label] = dict(total_b=total_b, proj_b=proj_b, decode_s=decode_s)
        print(f"{what} {label} (scripts/decode_serving.sh MODE={mode}"
              f"{' ' + ' '.join(extra) if extra else ''}{'' if quantized else ', LLM in bf16'}): "
              f"main {wall:.2f} s wall, load {seen['load_s']:.2f} s, decode {decode_s:.2f} s, "
              f"{assets['audio_seconds'] / decode_s:.1f} audio-s/s over the decode; the CLI logs "
              f"{done[-1] if done else 'nothing'}; peak memory {peak_gb:.2f} GB ({held_gb:.2f} "
              f"held before the run); LLM weights "
              f"{total_b / 1e9:.3f} GB ({proj_b / 1e9:.3f} GB projections); largest KV cache "
              f"{seen['kv_bytes'] / 1e9:.4f} GB; launches {nonzero(run)}, routes {routes}{spec} [{CARD}]",
              flush=True)
        if label == "continuous":
            out["model"] = model
        del model, seen
    for label in preds:
        if label != "plain":
            same = sum(preds[label][k] == preds["plain"][k] for k in keys)
            pos = sum(len(preds["plain"][k]) for k in keys)
            agree = sum(a == b for k in keys for a, b in zip(preds[label][k], preds["plain"][k]))
            print(f"{what} {label}: {same} of {len(keys)} utterances' tokens equal plain's, "
                  f"{agree} of {pos} token positions (int8 weights' plain; bf16, reported, not "
                  f"asserted)", flush=True)
    ratio = out["plain"]["total_b"] / out["plain bf16"]["total_b"]
    print(f"{what}: int8 LLM {out['plain']['total_b'] / 1e9:.3f} GB against bf16 "
          f"{out['plain bf16']['total_b'] / 1e9:.3f} GB ({ratio:.3f}x; projections "
          f"{out['plain']['proj_b'] / 1e9:.3f} against {out['plain bf16']['proj_b'] / 1e9:.3f} GB); "
          f"decode {out['plain']['decode_s']:.2f} s int8 against {out['plain bf16']['decode_s']:.2f} s "
          f"bf16 [{CARD}]", flush=True)
    if ratio > 0.6:
        fail(f"{what}: the int8 LLM takes {ratio:.3f}x the bf16 LLM's bytes, above 0.6")
    return out["model"]


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def launch_delta(counters, before: dict) -> dict:
    """Launches by wrapper and by norm route since ``before`` (a
    :func:`launch_snapshot`)."""
    now = launch_snapshot(counters)
    return {k: now[k] - before[k] for k in now}


def launch_snapshot(counters) -> dict:
    snap = {n: f.launches for n, f in counters.items()}
    for n in MAIN_ROUTES:
        snap.update({f"{n}.{r}": c for r, c in counters[n].routes.items()})
    return snap


def want_launches(counters, flash=0, ln=0, rms=0) -> dict:
    """Exact launches by wrapper and route: ``ln`` front halves (142 LayerNorm
    launches on the vectorised route and 1 staged each), ``rms`` RMSNorm
    launches (vectorised), ``flash`` flash forwards."""
    want = {n: 0 for n in counters}
    want.update(flash_attention_fwd=flash, rms_norm_fwd=rms,
                layer_norm_fwd=sum(LN_ROUTES_PER_PASS.values()) * ln)
    for n in MAIN_ROUTES:
        want.update({f"{n}.{r}": 0 for r in counters[n].routes})
    want.update({f"layer_norm_fwd.{r}": c * ln for r, c in LN_ROUTES_PER_PASS.items()})
    want["rms_norm_fwd.vec"] = rms
    return want


def shape_groups(batches) -> list:
    """The sizes of the same-shape groups the pools' front half stacks."""
    groups: dict = {}
    for b in batches:
        sig = tuple(sorted((k, tuple(v.shape)) for k, v in b.items()))
        groups[sig] = groups.get(sig, 0) + 1
    return list(groups.values())


def instrument_pool(counters, dec, rec: dict) -> None:
    """Count the launches of each chunk and each refill of ``dec``, checked
    exactly: a chunk is ``sync_every`` forwards of the pool (57 RMSNorm
    each, nothing else); a refill of k requests runs the front half once a
    power-of-two chunk of each same-shape group (70 flash, 143 LayerNorm)
    and the prefill once a power-of-two chunk of k (28 flash, 57 RMSNorm)."""
    real_launch, real_refill = dec._launch_chunk, dec._refill_many

    def launch():
        before = launch_snapshot(counters)
        copy = real_launch()
        got = launch_delta(counters, before)
        want = want_launches(counters, rms=RMS_PER_FORWARD * dec.sync_every)
        if got != want:
            fail(f"{rec['what']}: a chunk launched {got}, not {want}")
        rec["chunks"].append(got)
        return copy

    def refill(slot_req):
        before = launch_snapshot(counters)
        real_refill(slot_req)
        got = launch_delta(counters, before)
        fronts = sum(bin(n).count("1") for n in shape_groups(
            [dec._payload_batch(p) for _, _, p in slot_req]))
        prefills = bin(len(slot_req)).count("1")
        want = want_launches(counters, flash=ENC_FLASH * fronts + LLM_LAYERS * prefills,
                             ln=fronts, rms=RMS_PER_FORWARD * prefills)
        if got != want:
            fail(f"{rec['what']}: a refill of {len(slot_req)} launched {got}, not {want}")
        rec["refills"].append((len(slot_req), fronts, prefills, got))

    dec._launch_chunk, dec._refill_many = launch, refill


def phase_serving_pools(torch, dev, launches, model, assets) -> dict:
    """Phase 8c: the greedy and speculative pools driven directly at full
    width on 8b's int8 model: the 32 requests with ``stop_after`` caps drawn
    from POOL_CAPS, the greedy pool uncapped to compare, exact launches per
    chunk and per refill, one chunk profiled, and an oracle draft through
    ``generate(draft_ids=...)`` against plain greedy.  Fails unless each
    request is answered exactly once with at most its cap of tokens.  Adds
    the launches to ``launches``; returns the launch columns of the
    ``kernels`` line and phase 3's cases at the pools' largest shapes."""
    import numpy as np

    from ps_slm_tpu_torch.config import RunConfig, parse_cli
    from ps_slm_tpu_torch.data.dataset import Collator, MultiTaskDataset
    from ps_slm_tpu_torch.data.spm import SenseVoiceTokenizer
    from ps_slm_tpu_torch.data.tokenizer import load_tokenizer
    from ps_slm_tpu_torch.inference import ctc_draft, make_pool_decoder, speculative
    from ps_slm_tpu_torch.inference.generate import generate
    from ps_slm_tpu_torch.models.tasu import prepare_merged

    what = "serving pools"
    counters = kernel_counters()
    cfg = parse_cli(serving_args(assets, "continuous", "unused", DECODE_MAX_NEW), RunConfig())
    tc, dc = cfg.train_config, cfg.dataset_config
    dc.inference_mode = True
    tok = load_tokenizer(assets["llm_path"])
    enc_tok = SenseVoiceTokenizer(assets["encoder_path"])
    ds = MultiTaskDataset(dc, tok, "test", encoder_tokenizer=enc_tok)
    coll = Collator(tok, dc, inference_mode=True)
    samples = list(ds)
    reqs = [(s.key, {k: torch.from_numpy(v).to(dev) for k, v in coll([s]).items()
                     if isinstance(v, np.ndarray)}) for s in samples]
    rng = np.random.default_rng(0)
    caps = {k: int(rng.integers(POOL_CAPS[0], POOL_CAPS[1] + 1)) for k, _ in reqs}
    eos = tok.eos_token_id
    drafts = {k: ctc_draft(model, b, enc_tok, tok) for k, b in reqs}
    spec_tc = parse_cli(serving_args(assets, "speculative", "unused", DECODE_MAX_NEW)
                        + ["++train_config.continuous_batching=true"], RunConfig()).train_config

    def pool(kind, stop_after=None):
        dec = make_pool_decoder(model, spec_tc if kind == "speculative" else tc, dc,
                                eos_token_id=eos)
        rec = {"what": f"{what} {kind}", "chunks": [], "refills": []}
        instrument_pool(counters, dec, rec)
        items = [(k, (b, drafts[k], len(drafts[k])) if kind == "speculative" else b)
                 for k, b in reqs]
        torch.cuda.synchronize()
        reset_counters(counters)
        t0 = time.perf_counter()
        got = list(dec.run(iter(items), stop_after=stop_after))
        wall = time.perf_counter() - t0
        for n, c in launch_snapshot(counters).items():
            launches[n] = launches.get(n, 0) + c
        answered = [k for k, _ in got]
        if sorted(answered) != sorted(caps):
            fail(f"{rec['what']}: answered {sorted(answered)}, not each request once")
        got = dict(got)
        if stop_after:
            over = {k: len(v) for k, v in got.items() if len(v) > stop_after[k]}
            if over:
                fail(f"{rec['what']}: requests over their cap {over}")
        return got, wall, rec, dec

    full, wall_full, rec_full, _ = pool("greedy")
    capped, wall_cap, rec_cap, _ = pool("greedy", caps)
    spec, wall_spec, rec_spec, dec_spec = pool("speculative", caps)
    n_tok = {k: len(v) for k, v in capped.items()}
    for label, got, wall, rec in (("greedy, uncapped", full, wall_full, rec_full),
                                  ("greedy, capped", capped, wall_cap, rec_cap),
                                  ("speculative, capped", spec, wall_spec, rec_spec)):
        agree = sum(np.array_equal(got[k], full[k][:len(got[k])]) for k in got)
        print(f"{what} {label}: {len(got)} requests in {wall:.2f} s, "
              f"{sum(map(len, got.values()))} tokens ({sum(map(len, got.values())) / wall:.1f} "
              f"tokens/s); {len(rec['chunks'])} chunks of {nonzero(rec['chunks'][0])} launches; "
              f"{len(rec['refills'])} refills (requests, front halves, prefills) "
              f"{[r[:3] for r in rec['refills']]}, the first's launches "
              f"{nonzero(rec['refills'][0][3])}; "
              f"{agree} of {len(got)} requests' tokens a prefix of the uncapped run's "
              f"(bf16, reported) [{CARD}]", flush=True)
    print(f"{what}: caps {json.dumps(caps)}; capped tokens {json.dumps(n_tok)}", flush=True)

    # an oracle draft (plain greedy's own tokens) through generate, on the
    # first 16 requests as one static batch
    orc = []
    real_spec = speculative.speculative_greedy_generate

    def spec_fn(*args, **kwargs):
        out, n_fwd = real_spec(*args, **kwargs)
        orc.append(n_fwd)
        return out, n_fwd

    speculative.speculative_greedy_generate = spec_fn
    try:
        for i in (0,):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in coll(samples[i:i + 16]).items()
                     if isinstance(v, np.ndarray)}
            kw = dict(eos_token_id=eos, num_beams=1, max_new_tokens=DECODE_MAX_NEW)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = generate(model, batch, **kw)
            torch.cuda.synchronize()
            t_plain = time.perf_counter() - t0
            ids = plain.clone()
            lens = (plain != eos).sum(1)
            t0 = time.perf_counter()
            oracle = generate(model, batch, draft_ids=ids, draft_lens=lens, spec_window=8, **kw)
            torch.cuda.synchronize()
            t_orc = time.perf_counter() - t0
            same = int((oracle == plain).all(1).sum())
            print(f"{what} oracle draft, batch {i // 16} ({ids.shape[0]} rows): {orc[-1]} forwards "
                  f"(plain greedy: {min(int(lens.max()) + 1, DECODE_MAX_NEW)}), generate {t_orc * 1e3:.1f} ms "
                  f"against plain greedy {t_plain * 1e3:.1f} ms; {same} of {ids.shape[0]} rows "
                  f"equal (bf16, reported) [{CARD}]", flush=True)
    finally:
        speculative.speculative_greedy_generate = real_spec

    # one greedy pool chunk profiled, the pool full
    dec = make_pool_decoder(model, tc, dc, eos_token_id=eos)
    dec._emitted_n = [0] * dec.num_slots
    dec._free = []
    dec._refill_many([(i, k, b) for i, (k, b) in enumerate(reqs[:dec.num_slots])])

    def chunk():
        with torch.inference_mode():
            dec._launch_chunk().get()

    chunk()
    prof = profiled(torch, chunk)
    print_profiled(f"{what} greedy chunk ({dec.sync_every} steps of {dec.num_slots} slots)", prof)

    # phase 3's cases at the pools' largest shapes: the first refill's
    # prefill (k x prefill_len, left-padded), the largest request's front
    # half, and the step rows of the greedy, speculative and beam pools
    k = dec.num_slots
    with torch.inference_mode():
        valid = [int(prepare_merged(model, b, left_padding=True, generate_mode=True)
                     .attention_mask.sum()) for _, b in reqs[:k]]
    big = max(reqs, key=lambda kb: kb[1]["waveform"].shape[1])[1]
    frames = batch_shapes(big, model.fbank_cfg)[1]
    P = dc.eval_max_frame_length
    flash = (("serving pool prefill", k, P, 12, 2, True, [P - v for v in valid], [P] * k),
             ("serving pool encoder", 1, frames + 4, 4, 4, False, [0], [frames + 4]))
    norm = (("layer_norm_fwd", frames + 4, 560, None), ("layer_norm_fwd", frames + 4, 512, None),
            ("layer_norm_fwd", frames, 25055, None), ("rms_norm_fwd", k * P, 1536, None),
            ("rms_norm_fwd", k, 1536, None), ("rms_norm_fwd", k * tc.spec_window, 1536, None),
            ("rms_norm_fwd", k * 4, 1536, None))
    del dec, dec_spec
    return {"chunk": {"greedy": rec_cap["chunks"][0], "speculative": rec_spec["chunks"][0]},
            "refill": rec_cap["refills"][0][3], "flash": flash, "norm": norm}


# ---------------------------------------------------------------------------
# phase 10: the streaming server, cli/serve.py
# ---------------------------------------------------------------------------

# 10a: (label, overrides after scripts/decode_serving.sh's MODE=plain and
# SERVE_FP32_ARGS); on the card the greedy ones' texts must equal plain
# greedy decode's
SERVE_FP32_ROUTES = (
    ("pool", ["++train_config.serve_route=pool"]),
    ("static", ["++train_config.serve_route=static"]),
    ("stream_partials", ["++train_config.stream_partials=true"]),
    ("speculative_ctc", ["++train_config.speculative_ctc=true"]),
    ("beam-4 pool", ["++train_config.serve_route=pool", "++train_config.num_beams=4"]),
)
SERVE_GREEDY = ("pool", "static", "stream_partials", "speculative_ctc")
# 10b: scripts/decode_serving.sh's MODE=continuous knobs (8 slots, the
# 2 000-frame prefill bucket), 32 requests; random weights never emit EOS,
# so every completion is DECODE_MAX_NEW long and auto needs a threshold
# above it to leave the pool
SERVE_RUNS_CLI = (
    ("pool", ["++train_config.serve_route=pool"]),
    ("static", ["++train_config.serve_route=static"]),
    ("auto", ["++train_config.serve_route=auto", "++train_config.route_probe=8",
              "++train_config.route_static_below=64"]),
    ("stream_partials", ["++train_config.stream_partials=true"]),
)
SERVE_GAP_S = 0.1       # 10b stream: one request down a pipe every 100 ms


def write_requests(manifest_dir: str, path: str, n=None) -> list:
    """A serve CLI requests file: the key, path and task of the first ``n``
    manifest rows, then a malformed line and an unreadable path (last, so
    the good requests draw their prompts in the decode CLI's order);
    returns the good keys."""
    with open(os.path.join(manifest_dir, "multitask.jsonl")) as f:
        rows = [json.loads(line) for line in f][:n]
    lines = [json.dumps({"key": r["key"], "path": r["path"], "task": r["task"]}) for r in rows]
    lines += ["{not json", json.dumps({"key": "unreadable",
                                       "path": os.path.join(manifest_dir, "missing.wav")})]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return [r["key"] for r in rows]


class LineClock:
    """A ``stdout`` for ``cli.serve.main``: each JSON line with the host
    time it was written."""

    def __init__(self):
        self.buf, self.lines = "", []

    def write(self, s: str) -> int:
        self.buf += s
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            self.lines.append((time.perf_counter(), json.loads(line)))
        return len(s)

    def flush(self) -> None:
        pass


def serve_finals(what: str, lines, good) -> dict:
    """{key: final text}; fails unless every good key has one final line,
    the two bad lines one error line each, and every partial line is a
    growing prefix of its key's final text (a trailing U+FFFD aside: a
    prefix can end inside a UTF-8 character that the next token
    completes)."""
    finals, errors, last = {}, [], {}
    for _, r in lines:
        if "error" in r:
            errors.append(r["key"])
        elif r.get("partial"):
            text = r["text"].rstrip("�")
            if r["key"] in finals or not text.startswith(last.get(r["key"], "")):
                fail(f"{what}: partial line {r} after its final or not growing")
            last[r["key"]] = text
        elif r["key"] in finals:
            fail(f"{what}: {r['key']} answered twice")
        else:
            finals[r["key"]] = r["text"]
    if sorted(finals) != sorted(good) or len(errors) != 2 or "unreadable" not in errors:
        fail(f"{what}: answered {sorted(finals)}, errors {errors}; want {sorted(good)} and the "
             f"two bad lines")
    for key, text in last.items():
        if not finals[key].startswith(text):
            fail(f"{what}: a partial of {key} is not a prefix of its final text")
    return finals


@contextlib.contextmanager
def serve_segments():
    """Record each ``run`` of a slot pool or a static decoder while the
    serve CLI runs (``serve_route=auto`` runs one per segment): (route,
    completions, seconds)."""
    from ps_slm_tpu_torch.inference import continuous, static_serve

    segs: list = []
    saved = [(continuous._SlotPoolBase, "pool"), (static_serve.StaticBatchDecoder, "static")]
    real = {cls: cls.run for cls, _ in saved}

    def timed(cls, kind):
        def run(self, *args, **kwargs):
            t, n = time.perf_counter(), 0
            for item in real[cls](self, *args, **kwargs):
                n += 1
                yield item
            segs.append((kind, n, time.perf_counter() - t))
        return run

    for cls, kind in saved:
        cls.run = timed(cls, kind)
    try:
        yield segs
    finally:
        for cls, _ in saved:
            cls.run = real[cls]


class Started:
    """A request source for ``cli.serve.main``'s reader thread that notes
    the host time the server starts reading it (its model loaded)."""

    def __init__(self, f):
        import threading

        self.f, self.event, self.t = f, threading.Event(), None

    def __iter__(self):
        self.t = time.perf_counter()
        self.event.set()
        return iter(self.f)


def serve_requests(serve_main, args: list, req_path: str, gap) -> tuple:
    """``cli.serve.main`` on the lines of ``req_path``, given on stdin: read
    from the file, or with ``gap`` seconds from a pipe that a writer thread
    fills one line at a time once the server reads.  Returns (the output
    lines with their times, the time reading started, the time the last
    line was written or None)."""
    import threading

    clock = LineClock()
    if gap is None:
        with open(req_path) as f:
            src = Started(f)
            if serve_main(args, stdin=src, stdout=clock) != 0:     # default device: cuda
                fail("serve: main returned nonzero")
        return clock.lines, src.t, None
    with open(req_path) as f:
        lines = f.read().splitlines()
    r, w = os.pipe()
    wrote: list = []
    with os.fdopen(r) as pipe_r:
        src = Started(pipe_r)

        def writer():
            with os.fdopen(w, "w") as out:
                src.event.wait(600)
                for line in lines:
                    time.sleep(gap)
                    out.write(line + "\n")
                    out.flush()
                    wrote.append(time.perf_counter())

        th = threading.Thread(target=writer, daemon=True)
        th.start()
        rc = serve_main(args, stdin=src, stdout=clock)
        th.join(timeout=60)
    if rc != 0 or th.is_alive():
        fail(f"serve through a pipe: main returned {rc}, writer alive {th.is_alive()}")
    return clock.lines, src.t, wrote[-1]


def serve_cli_fp32_run(device) -> dict:
    """Phase 10a's runs on ``device``, on its own copy of the assets and
    requests file in a temporary directory (deleted after): through every
    route of SERVE_FP32_ROUTES, by label the output lines (the directory's
    path in an error line written ``<root>``), ``main``'s wall seconds and
    the token ids by key; the good keys; on the card also plain greedy
    decode's token ids (the decode CLI, MODE=plain)."""
    import torch

    from ps_slm_tpu_torch.cli import decode, serve
    from ps_slm_tpu_torch.config import half_audio_configs
    from ps_slm_tpu_torch.models.tasu import model_factory

    what, name = "serve CLI fp32", torch.device(device).type
    root = tempfile.mkdtemp(prefix="serve_fp32_")
    try:
        tc, mc = half_audio_configs(*FP32_DEPTH_LAYERED, seed=0)
        assets = write_assets(root, model_factory(tc, mc, device="cpu"),
                              llm_dtype=torch.bfloat16, utts=SERVE_FP32_UTTS)
        write_bpe_model(assets["encoder_path"], vocab=mc.encoder_dim)
        req = os.path.join(root, "requests.jsonl")
        run = {"good": write_requests(assets["data"], req), "lines": {}, "walls": {},
               "toks": {}}
        if name == "cuda":
            log = os.path.join(root, "decode", "test")
            with recorded_tokens() as calls:
                if decode.main(serving_args(assets, "plain", log, FP32_NEW, mc.llm_dim,
                                            mc.encoder_dim) + SERVE_FP32_ARGS, device=device) != 0:
                    fail(f"{what}: the plain decode returned nonzero")
            run["greedy"] = tokens_by_key(log + "_pred", calls, f"{what} plain decode")
        base = [a for a in serving_args(assets, "plain", os.path.join(root, "serve"), FP32_NEW,
                                        mc.llm_dim, mc.encoder_dim)
                if not a.startswith("decode_log=")] + SERVE_FP32_ARGS
        for label, extra in SERVE_FP32_ROUTES:
            clock = LineClock()
            t1 = time.time()
            with recorded_tokens() as calls:
                if serve.main(base + extra + [req], stdout=clock, device=device) != 0:
                    fail(f"{what} {label} on {name}: main returned nonzero")
            run["walls"][label] = time.time() - t1
            run["lines"][label] = [(t, {k: v.replace(root, "<root>") if isinstance(v, str) else v
                                        for k, v in r.items()}) for t, r in clock.lines]
            # without partials, the decodes are the final lines', in order
            keys = [r["key"] for _, r in clock.lines if "text" in r]
            run["toks"][label] = dict(zip(keys, map(tuple, calls)))
        return run
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_serve_cli_fp32(torch, dev, ref) -> None:
    """Phase 10a: ``cli.serve.main`` in fp32 at full width and reduced depth
    (8a's 2+1 encoder blocks, 1 LLM layer, assets and knobs: int8 weights,
    3 slots, 8 new tokens) on 4 utterances and two bad lines, through the
    pool, static batches, streamed partials, CTC drafts and the beam-4 pool,
    on the card (:func:`serve_cli_fp32_run`) and on the CPU (``ref``, its
    run in the reference worker).  Each route's final and error lines must be
    identical card against CPU (as sets: lines come in completion order),
    and on the card the greedy routes' token ids equal plain greedy decode's
    (the decode CLI, MODE=plain; streamed partials: the pool's texts)."""
    what = "serve CLI fp32"
    t0 = time.time()
    card = serve_cli_fp32_run(dev)
    cpu = ref.result()
    good, greedy = card["good"], card["greedy"]
    out, walls, toks = {}, {}, {}
    for name, run in (("cuda", card), ("cpu", cpu)):
        for label in run["lines"]:
            out[label, name] = run["lines"][label]
            walls[label, name], toks[label, name] = run["walls"][label], run["toks"][label]
    bad = []
    for label, _ in SERVE_FP32_ROUTES:
        finals = {n: serve_finals(f"{what} {label} on {n}", out[label, n], good)
                  for n in ("cuda", "cpu")}
        lines = {n: sorted(json.dumps(r, sort_keys=True) for _, r in out[label, n]
                           if not r.get("partial")) for n in ("cuda", "cpu")}
        partials = {n: sum(1 for _, r in out[label, n] if r.get("partial")) for n in ("cuda", "cpu")}
        same_cpu = lines["cuda"] == lines["cpu"]
        if label == "stream_partials":   # its decodes include the partials': texts against the pool's
            same_greedy = finals["cuda"] == serve_finals(what, out["pool", "cuda"], good)
        else:
            same_greedy = toks[label, "cuda"] == {k: greedy[k] for k in good}
        if not same_cpu or (label in SERVE_GREEDY and not same_greedy):
            bad.append(label)
        print(f"{what} {label} (2+1 encoder blocks, 1 LLM layer, full width, quantized, "
              f"{FP32_NEW} new tokens, {len(good)} requests + 2 bad lines): final and error lines "
              f"{'identical to' if same_cpu else 'DIFFERENT from'} the CPU's; texts "
              f"{'equal' if same_greedy else 'unequal'} to plain greedy decode's on the card"
              f"{'' if label in SERVE_GREEDY else ' (beam: not asserted)'}; partial lines card "
              f"{partials['cuda']}, CPU {partials['cpu']}; main {walls[label, 'cuda']:.1f} s card, "
              f"{walls[label, 'cpu']:.1f} s CPU", flush=True)
    print(f"{what}: {time.time() - t0:.1f} s", flush=True)
    if bad:
        fail(f"{what}: {bad} differ card against CPU or from plain greedy on the card")


def phase_serve_cli(torch, dev, launches, assets) -> dict:
    """Phase 10b: ``cli.serve.main`` at full size, bf16, on phase 8's
    assets with scripts/decode_serving.sh's MODE=continuous knobs (int8
    weights, 8 slots, the 2 000-frame prefill bucket): 32 requests of 2-12
    s and two bad lines on stdin, DECODE_MAX_NEW new tokens, through the
    pool, static batches, ``serve_route=auto`` (probe 8, static below 64
    tokens) and streamed partials fed down a pipe one request every 100 ms
    once the server reads (times from then: the model's load apart).
    Fails unless every good request is answered once, the bad lines get
    error lines, partials grow as prefixes of their final text, the first
    streamed line (a partial) arrives before the last request is written, and every
    norm launch stays on its main route.  Adds the launches to
    ``launches``; returns each run's launches."""
    from ps_slm_tpu_torch.cli import serve
    from ps_slm_tpu_torch.config import half_audio_configs

    what = "serve CLI"
    counters = kernel_counters()
    _, mc = half_audio_configs()
    root = os.path.dirname(assets["data"])
    req = os.path.join(root, "requests.jsonl")
    good = write_requests(assets["data"], req)
    log = os.path.join(root, "serve")
    base = [a for a in serving_args(assets, "continuous", log, DECODE_MAX_NEW, mc.llm_dim,
                                    mc.encoder_dim) if not a.startswith("decode_log=")]
    per_run = {}
    for label, extra in SERVE_RUNS_CLI:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counters(counters)
        args = base + extra
        with serve_segments() as segs, recorded_tokens() as calls:
            t_main = time.perf_counter()
            lines, t0, last_write = serve_requests(
                serve.main, args, req, SERVE_GAP_S if label == "stream_partials" else None)
            wall = time.perf_counter() - t0             # serving, after the model's load
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        run = launch_snapshot(counters)
        per_run[label] = run
        for n, c in run.items():
            launches[n] = launches.get(n, 0) + c
        routes = {n: dict(counters[n].routes) for n in MAIN_ROUTES}
        if routes["rms_norm_fwd"]["general"] or routes["layer_norm_fwd"]["general"] \
                or routes["layer_norm_fwd"]["held"] or not run["flash_attention_fwd"]:
            fail(f"{what} {label}: a norm left its main route or no flash ran: {routes}")
        finals = serve_finals(f"{what} {label}", lines, good)
        first = next(t for t, r in lines if "text" in r and not r.get("partial"))
        n_part = sum(1 for _, r in lines if r.get("partial"))
        tokens = "" if n_part else (
            f", {sum(map(len, calls))} tokens ({sum(map(len, calls)) / wall:.1f} tokens/s)")
        decisions = ""
        if label == "auto":
            with open(log + ".log") as f:
                decisions = [line.split(" - ", 1)[-1].strip() for line in f
                             if "serve_route=auto" in line]
            decisions = f"; decisions {decisions}"
        stream = ""
        if last_write is not None:
            streamed = next(t for t, r in lines if "text" in r)    # a partial or a final
            stream = (f"; first streamed line {streamed - t0:.2f} s, last request written at "
                      f"{last_write - t0:.2f} s, {n_part} partial lines")
            if streamed >= last_write:
                fail(f"{what} {label}: the first result came after the last request was written")
        rates = [(k, n, round(n / s, 2) if s else 0.0) for k, n, s in segs]
        print(f"{what} {label} (scripts/decode_serving.sh MODE=continuous, {' '.join(extra)}): "
              f"main {t0 - t_main + wall:.2f} s, of which loading {t0 - t_main:.2f} s and serving "
              f"{len(finals)} requests {wall:.2f} s ({len(finals) / wall:.2f} requests/s"
              f"{tokens}); time to the first result {first - t0:.2f} s; segments (route, "
              f"completions, completions/s) {rates}{decisions}{stream}; peak memory "
              f"{peak_gb:.2f} GB; launches {nonzero({n: c for n, c in run.items() if '.' not in n})}, "
              f"routes {routes} [{CARD}]",
              flush=True)
    return per_run


# ---------------------------------------------------------------------------
# phase 11: PEFT finetuning through cli/finetune.py
# ---------------------------------------------------------------------------

# 11a: (label, overrides after the half_audio recipe's and use_peft=true)
PEFT_FP32_SETUPS = (
    ("LoRA", ["++train_config.peft_config.lora_dropout=0.0"]),
    ("QLoRA int8", ["++train_config.peft_config.lora_dropout=0.0",
                    "++train_config.quantization=true"]),
    ("prefix", ["++train_config.peft_config.peft_method=prefix"]),
    ("llama-adapter", ["++train_config.peft_config.peft_method=llama_adapter"]),
)
# LoRA's trainable parameters at r 64 on Qwen2.5-1.5B's seven projections:
# r x 28 layers x the sum of their in + out widths (q 1536 + 1536, k and v
# 1536 + 256, o 1536 + 1536, gate and up 1536 + 8960, down 8960 + 1536)
LORA_PARAMS = 64 * 28 * 41216


@contextlib.contextmanager
def base_snapshot(torch):
    """Hold the train step ``cli.finetune.main`` builds and a CPU copy of
    every LLM tensor it does not train (parameters and quantized codes)."""
    from ps_slm_tpu_torch.training import step as step_mod

    seen: dict = {}
    real = step_mod.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)
        seen["step"] = step
        seen["base"] = {n: t.detach().cpu().clone() for n, t in step.model.state_dict().items()
                        if n.startswith("llm.") and n not in step.trainable}
        return step

    step_mod.make_train_step = make
    try:
        yield seen
    finally:
        step_mod.make_train_step = real


def base_unchanged(seen) -> bool:
    now = seen["step"].model.state_dict()
    return all(now[n].cpu().equal(t) for n, t in seen["base"].items())


@contextlib.contextmanager
def export_timer(torch):
    """Seconds and bytes of each reference and adapter export the finetune
    CLI writes."""
    from ps_slm_tpu_torch.training import checkpoint as ckpt

    rec: list = []
    saved = {name: getattr(ckpt, name) for name in ("export_reference_checkpoint",
                                                    "export_peft_adapters")}

    def timed(name):
        def run(model, path, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = saved[name](model, path, **kwargs)
            files = [path] if name.startswith("export_reference") else [
                os.path.join(path, f) for f in os.listdir(path)]
            rec.append((name, time.perf_counter() - t, sum(os.path.getsize(f) for f in files)))
            return out
        return run

    for name in saved:
        setattr(ckpt, name, timed(name))
    try:
        yield rec
    finally:
        for name, fn in saved.items():
            setattr(ckpt, name, fn)


@contextlib.contextmanager
def adapters_only(torch):
    """While the finetune CLI runs, its checkpoints write the PEFT adapters
    alone: no train state and no reference export (11a compares only the
    adapters; 11b writes both at full size)."""
    from ps_slm_tpu_torch.training import checkpoint as ckpt

    saved = (ckpt.save_train_state, ckpt.export_reference_checkpoint)
    ckpt.save_train_state = lambda path, state: 0
    ckpt.export_reference_checkpoint = lambda model, path, **kwargs: {}
    try:
        yield
    finally:
        ckpt.save_train_state, ckpt.export_reference_checkpoint = saved


# 11a's overrides after the half_audio recipe's
PEFT_FP32_EXTRA = [
    "++train_config.mixed_precision=false", "++dataset_config.fbank.dither=0.0",
    "++train_config.num_epochs=1", "++train_config.run_validation=false",
    "++train_config.batching_strategy=padding", "++train_config.batch_size_training=2",
    "++train_config.lr=1e-3", "++train_config.warmup_steps=1", "++train_config.save_last=true",
    "++log_config.log_interval=1", "++train_config.use_peft=true",
    "++train_config.freeze_projector=true"]


def peft_fp32_runs(device, root: str = None) -> dict:
    """Phase 11a's runs on ``device`` over ``root``'s assets (written there
    first; none given: a temporary directory, deleted after): for each of
    PEFT_FP32_SETUPS, its initial adapter drawn on the CPU from the seeded
    config and handed over as ``peft_ckpt`` (QLoRA takes LoRA's), then
    ``cli.finetune.main``: by label the losses, the exported adapters,
    ``main``'s wall seconds, whether the base LLM kept its bits and AdamW's
    first moments; on the card also the model, its args and output
    directory."""
    import torch

    from ps_slm_tpu_torch.cli import finetune
    from ps_slm_tpu_torch.config import RunConfig, half_audio_configs, parse_cli
    from ps_slm_tpu_torch.models.tasu import model_factory
    from ps_slm_tpu_torch.training import checkpoint as ckpt

    what, name = "PEFT finetune fp32", torch.device(device).type
    own = root is None
    root = tempfile.mkdtemp(prefix="peft_fp32_") if own else root
    try:
        tc, mc = half_audio_configs(*FP32_DEPTH_LAYERED, seed=0)
        assets = write_assets(root, model_factory(tc, mc, device="cpu"),
                              llm_dtype=torch.bfloat16, utts={"ark": 1, "wav": 0, "flac": 0})
        write_manifest(os.path.join(root, "train"), {"ark": 2, "wav": 1, "flac": 1},
                       PEFT_SECONDS, seed=1)
        inits, runs = {}, {}
        for label, peft in PEFT_FP32_SETUPS:
            # one initial adapter for both devices (each device's generator
            # draws its own), handed over as peft_ckpt; QLoRA takes LoRA's
            method = next((a for a in peft if "peft_method" in a), "lora")
            if method not in inits:
                inits[method] = os.path.join(root, label.replace(" ", "_"), "init_adapter")
                cfg = parse_cli(finetune_args(assets, root, inits[method], llm_dim=mc.llm_dim,
                                              encoder_dim=mc.encoder_dim) + PEFT_FP32_EXTRA
                                + peft, RunConfig())
                ckpt.export_peft_adapters(
                    model_factory(cfg.train_config, cfg.model_config, device="cpu"),
                    inits[method])
            out = os.path.join(root, label.replace(" ", "_"), name)
            args = finetune_args(assets, root, out, llm_dim=mc.llm_dim,
                                 encoder_dim=mc.encoder_dim) + PEFT_FP32_EXTRA + peft + [
                f"peft_ckpt={inits[method]}"]
            with TrainProbe(torch, device) as probe, base_snapshot(torch) as seen, \
                    adapters_only(torch):
                t1 = time.time()
                if finetune.main(args, device=device) != 0:
                    fail(f"{what} {label} on {name}: main returned nonzero")
            adapter = torch.load(os.path.join(out, "last", "adapter", "adapter_model.bin"),
                                 weights_only=True)
            step = seen["step"]
            params = dict(step.model.named_parameters())
            moments = {n: step.optimizer.state[params[n]]["exp_avg"].detach().cpu()
                       for n in step.trainable}
            runs[label] = dict(losses=probe.losses(), adapter=adapter, wall=time.time() - t1,
                               same_base=base_unchanged(seen), moments=moments)
            if not own:
                runs[label].update(model=probe.model, args=args, out=out)
            probe.model = probe.largest = None
            del step, params, seen
        return {"runs": runs, "mc": mc}
    finally:
        if own:
            shutil.rmtree(root, ignore_errors=True)


def phase_peft_fp32(torch, dev, ref) -> None:
    """Phase 11a: ``cli.finetune.main`` with ``use_peft`` in fp32 at full
    width and reduced depth (2+1 encoder blocks, 1 LLM layer; phase 4e's
    kind of assets, 4 training utterances of 1-2 s, 2 steps of 2 rows, lr
    1e-3 after the warm-up's first step at 0; dither 0; the projector
    frozen, so only the adapters train; one initial adapter, drawn on the
    CPU, given as ``peft_ckpt``; ``last/`` writes the adapters alone, 11b
    writes the whole checkpoint), on the card (:func:`peft_fp32_runs`)
    against ``ref``, the CPU's runs: LoRA (dropout 0), QLoRA over int8,
    prefix tuning and llama-adapter.  Losses
    within PATH_TOL, the exported adapters (``last/adapter``) within
    ADAPTER_TOL and AdamW's first moments of every trained tensor within
    MOMENT_TOL of the tensor's largest, card against CPU; the base LLM
    bit-identical after training; the exported
    adapters, imported into a fresh model by ``peft_ckpt``'s
    ``import_peft_adapters``, reproduce the trained LLM's logits."""
    from ps_slm_tpu_torch.config import RunConfig, parse_cli
    from ps_slm_tpu_torch.models.tasu import model_factory
    from ps_slm_tpu_torch.training import checkpoint as ckpt

    what = "PEFT finetune fp32"
    t0 = time.time()
    root = tempfile.mkdtemp(prefix="peft_fp32_")
    bad = []
    try:
        card_runs = peft_fp32_runs(dev, root)
        mc = card_runs["mc"]
        cpu_runs = ref.result()["runs"]
        for label, _ in PEFT_FP32_SETUPS:
            runs = {"cuda": card_runs["runs"].pop(label), "cpu": cpu_runs[label]}
            card, cpu = runs["cuda"], runs["cpu"]
            loss_err = max(abs(a - b) for a, b in zip(card["losses"], cpu["losses"]))
            ad_err = max(float((card["adapter"][k] - cpu["adapter"][k]).abs().max())
                         for k in card["adapter"])
            # each trained tensor's gap over its own largest first moment
            # (0 over 0 where its gradient is 0 on both: LoRA's A before B
            # moves, llama-adapter's prompts before the gate does)
            mom_err = max(float((card["moments"][n] - m).abs().max())
                          / max(float(m.abs().max()), 1e-30) for n, m in cpu["moments"].items())
            # peft_ckpt's import into a fresh model: the trained LLM's logits
            cfg = parse_cli([a for a in card["args"] if not a.startswith("peft_ckpt=")],
                            RunConfig())
            fresh = model_factory(cfg.train_config, cfg.model_config, device=dev)
            ckpt.import_peft_adapters(fresh, os.path.join(card["out"], "last", "adapter"))
            x = torch.randn(2, 16, mc.llm_dim, generator=torch.Generator().manual_seed(0)).to(dev)
            pos = torch.arange(16, device=dev).expand(2, 16)
            with torch.no_grad():
                logit_err = float((fresh.llm.unembed(fresh.llm(x, None, pos)[0])
                                   - card["model"].llm.unembed(card["model"].llm(x, None, pos)[0]))
                                  .abs().max())
            ok = (len(card["losses"]) == 2 and sorted(card["adapter"]) == sorted(cpu["adapter"])
                  and sorted(card["moments"]) == sorted(cpu["moments"])
                  and loss_err <= PATH_TOL and ad_err <= ADAPTER_TOL and mom_err <= MOMENT_TOL
                  and card["same_base"] and cpu["same_base"]
                  and logit_err <= KERNEL_TOL["f32"][0])
            if not ok:
                bad.append(label)
            print(f"{what} {label} (2+1 encoder blocks, 1 LLM layer, full width, 2 steps of 2 "
                  f"rows): losses card {card['losses']} cpu {cpu['losses']}, max err "
                  f"{loss_err:.3e} (tol {PATH_TOL}); {len(card['adapter'])} exported adapter "
                  f"tensors, max err {ad_err:.3e} (tol {ADAPTER_TOL}); AdamW first moments of "
                  f"{len(card['moments'])} trained tensors, max err over each one's largest "
                  f"{mom_err:.3e} (tol {MOMENT_TOL}); base LLM bit-identical card "
                  f"{card['same_base']}, CPU {cpu['same_base']}; peft_ckpt re-import: logits "
                  f"max err {logit_err:.3e}; main {card['wall']:.1f} s card, {cpu['wall']:.1f} s "
                  f"CPU", flush=True)
            del runs, card, cpu, fresh
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"{what}: {time.time() - t0:.1f} s", flush=True)
    if bad:
        fail(f"{what}: {bad} disagree card against CPU, changed the base or did not re-import")


def phase_peft(torch, dev, launches: dict, chain: dict) -> dict:
    """Phase 11b: scripts/finetune_half_audio.sh's overrides with
    ``use_peft=true`` (LoRA r 64, alpha 16, the seven projections, dropout
    0.05) through ``cli.finetune.main`` at full size, bf16, for one epoch
    on phase 7's assets from 7a's export, validating once (one ``step_N``)
    and saving ``last/``; then QLoRA over int8 weights for the same epoch
    without checkpoints; 11c: ``cli.serve.main`` on the merged export with
    phase 7's 8 test utterances.  Fails unless every micro-step launches
    exactly 7b's kernels by route, LoRA trains exactly LORA_PARAMS
    parameters, the base LLM stays bit-identical and the adapters moved,
    and every serve request is answered.  Adds 11b's launches to
    ``launches``; returns its launches a micro-step."""
    from ps_slm_tpu_torch.cli import finetune, serve
    from ps_slm_tpu_torch.models.lora import ADAPTER_LEAVES

    what = "PEFT finetune"
    counters = kernel_counters()
    assets, root, init, dims = chain["assets"], chain["root"], chain["init"], chain["dims"]
    interval = chain["steps"] // 2 + 1        # one validation in the epoch
    out = os.path.join(root, "exp", "half_audio_lora")

    def args(out_dir, *extra):
        return [a if not a.startswith("ckpt_path=") else f"ckpt_path={init}"
                for a in finetune_args(assets, root, out_dir, **dims)] + [
            "++train_config.num_epochs=1", "++train_config.use_peft=true", *extra]

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(counters)
    with TrainProbe(torch, dev) as probe, base_snapshot(torch) as seen, \
            export_timer(torch) as exports:
        t0 = time.perf_counter()
        if finetune.main(args(out, f"++train_config.validation_interval={interval}",
                              "++train_config.save_last=true")) != 0:
            fail(f"{what}: main returned nonzero")
        wall = time.perf_counter() - t0
    run = launch_counts(counters)
    for n, c in run.items():
        launches[n] = launches.get(n, 0) + c
    check_step_launches(probe, LAUNCHES_PER_TRAIN_STEP, LN_ROUTES_PER_PASS, what)
    step = seen["step"]
    params = dict(step.model.named_parameters())
    n_lora = sum(params[n].numel() for n in step.trainable if n.endswith(("lora_a", "lora_b")))
    others = sorted({n.split(".")[0] for n in step.trainable if not n.endswith(ADAPTER_LEAVES)})
    same_base = base_unchanged(seen)
    moved = all(bool(params[n].any()) for n in step.trainable if n.endswith("lora_b"))
    tags = sorted(p for p in os.listdir(out) if p.startswith("step_"))
    print(f"{what} 11b (scripts/finetune_half_audio.sh + use_peft: LoRA r 64, alpha 16, 7 "
          f"projections, dropout 0.05; 1 epoch from 7a's export, validation every {interval}): "
          f"{probe.summary()}; launches a micro-step {nonzero(probe.steps[0]['launches'])} (7b's "
          f"{nonzero(LAUNCHES_PER_TRAIN_STEP)}); LoRA parameters {n_lora} (want {LORA_PARAMS}), "
          f"also training {others}; base LLM bit-identical {same_base}; every lora_b moved "
          f"{moved}; checkpoints {tags} + last; train states "
          f"{[(round(x['bytes'] / 1e9, 3), round(x['s'], 2)) for x in probe.saves]} (GB, s); "
          f"exports {[(n.split('_')[1], round(b / 1e9, 3), round(s, 2)) for n, s, b in exports]} "
          f"(kind, GB, s); main {wall:.1f} s [{CARD}]", flush=True)
    if n_lora != LORA_PARAMS or not same_base or not moved or len(tags) != 1:
        fail(f"{what}: {n_lora} LoRA parameters, base unchanged {same_base}, adapters moved "
             f"{moved}, checkpoints {tags}")
    per_step = probe.steps[0]["launches"]
    lora_peak = max(s["peak"] for s in probe.steps)
    del step, params, seen, probe
    torch.cuda.empty_cache()

    # QLoRA: the same epoch over int8 weights, no checkpoint
    out_q = os.path.join(root, "exp", "half_audio_qlora")
    torch.cuda.reset_peak_memory_stats()
    with TrainProbe(torch, dev) as probe_q, base_snapshot(torch) as seen_q:
        t0 = time.perf_counter()
        if finetune.main(args(out_q, "++train_config.quantization=true",
                              "++train_config.run_validation=false",
                              "++train_config.save_model=false")) != 0:
            fail(f"{what} QLoRA: main returned nonzero")
        wall = time.perf_counter() - t0
    same_q = base_unchanged(seen_q)
    q_peak = max(s["peak"] for s in probe_q.steps)
    print(f"{what} 11b QLoRA over int8 (the same epoch, no checkpoint): {probe_q.summary()}; base "
          f"LLM bit-identical {same_q}; peak memory {q_peak:.2f} GB against LoRA's "
          f"{lora_peak:.2f} GB; main {wall:.1f} s [{CARD}]", flush=True)
    if not same_q or not all(math.isfinite(x) for x in probe_q.losses()):
        fail(f"{what} QLoRA: the base changed or a loss is not finite")
    del seen_q, probe_q
    torch.cuda.empty_cache()

    # 11c: serve the merged export
    export = os.path.join(out, "last", "pytorch_model.bin")
    req = os.path.join(root, "requests_peft.jsonl")
    good = write_requests(assets["data"], req)
    log = os.path.join(root, "serve_peft")
    serve_args = [a if not a.startswith("ckpt_path=") else f"ckpt_path={export}"
                  for a in serving_args(assets, "continuous", log, DECODE_MAX_NEW, **dims)
                  if not a.startswith("decode_log=")]
    clock = LineClock()
    t0 = time.perf_counter()
    if serve.main(serve_args + ["++train_config.serve_route=static", req], stdout=clock) != 0:
        fail(f"{what} 11c: serve main returned nonzero")
    wall = time.perf_counter() - t0
    finals = serve_finals(f"{what} 11c", clock.lines, good)
    print(f"{what} 11c (cli.serve on 11b's merged last/ export, int8, static batches): "
          f"{len(finals)} of {len(good)} requests answered in {wall:.2f} s [{CARD}]", flush=True)
    return per_step


# ----------------------------------------------------------------------------
# phase 12: SenseVoice encoder training, standalone ASR, the other projectors
# and the voca_trans / raw-feature branches
# ----------------------------------------------------------------------------

ENC_UTTS = 8
ENC_SECONDS = (2.0, 6.0)
ENC_QUERIES = (4, 1, 2, 15)            # language en, event, emotion, textnorm woitn
ENC_RICH = (24885, -1, 25004, 25017)   # their labels: en, the event ignored, neutral, woitn
ENC_WARMUP, ENC_STEPS = 3, 10
HEAD_SCALE = 10.0       # 12a's CTC head x10: its Viterbi paths are no near-ties
ENC_FP32_STEPS = 2      # 12a's AdamW steps: the first at the warm-up's lr 0
MOVE_TOL = 1e-3         # 12a: ||change card - change CPU|| / ||change CPU||, a tensor
# 12a's projector moments, ||card - CPU|| / ||CPU|| a tensor: a ReLU input within
# rounding of 0 (one in the raw-feature run's 204 800) flips on one device and
# moves linear1's moments by ~1e-3 of their norm
PROJ_MOMENT_TOL = 1e-2
GRAD_FLOOR = 1e-3       # 12a: a gradient below this of its tensor's largest and off by
                        # more than this of itself card vs CPU is rounding noise; the
                        # projectors' moments are sized at least this of their largest
ASR_BATCH = 16
# a trained encoder's step: 70 SANM blocks, 2 LayerNorms each + after_norm + tp_norm
LAUNCHES_PER_ENC_STEP = dict(flash_attention_fwd=70, flash_attention_dq=70,
                             flash_attention_dkv=70, layer_norm_fwd=142, layer_norm_bwd=142,
                             rms_norm_fwd=0, rms_norm_bwd=0)
LN_ROUTES_ENC = {"vec": 142, "staged": 0, "held": 0, "general": 0}
QF_NORMS = 22           # the default q-former's LayerNorms: 1 + 8 x 2 + 4 cross + out_norm
PROJECTOR_FP32_FRAMES = (100, 76)   # 12a's ragged rows (the CPU side sets 12a's time)
# phase 3 at the q-former's LayerNorms: 4 rows x 64 queries, its 768-wide
# post-LN layers (eps 1e-12) and the 1536-wide output norm (eps 1e-5)
QF_NORM_CASES = (("layer_norm_fwd", 256, 768, None, 1e-12),
                 ("layer_norm_fwd", 256, 1536, None))
QF_NORM_BWD_CASES = tuple(("layer_norm_bwd",) + c[1:] for c in QF_NORM_CASES)
# (label, projector, model config, train flags) of 12a and 12d; the
# posterior projectors read the 25 055-wide PSD posterior, cov1d-linear and
# the raw-feature baseline the encoder's 512-wide output, voca_trans maps
# it to the LLM's 151 936 classes
PROJECTOR_RUNS = (
    ("simple_linear", "simple_linear", dict(encoder_dim=25055, encoder_projector_ds_rate=2),
     dict(ctc_posterior=True, do_psd=True)),
    ("linear", "linear", dict(encoder_dim=25055, encoder_projector_ds_rate=2),
     dict(ctc_posterior=True, do_psd=True)),
    ("cov1d-linear", "cov1d-linear", dict(encoder_dim=512, encoder_projector_ds_rate=2),
     dict(ctc_posterior=False)),
    ("cross-attention", "cross-attention", dict(encoder_dim=25055),
     dict(ctc_posterior=True, do_psd=True)),
    ("q-former", "q-former", dict(encoder_dim=25055), dict(ctc_posterior=True, do_psd=True)),
    ("voca_trans", "simple_linear", dict(encoder_dim=512, llm_dim=151936),
     dict(ctc_posterior=True, voca_trans=True, do_psd=True)),
    ("voca_trans top1", "simple_linear", dict(encoder_dim=512, llm_dim=151936),
     dict(ctc_posterior=True, voca_trans=True, do_psd=True, top1_emb=True)),
    ("raw features", "linear", dict(encoder_dim=512, encoder_projector_ds_rate=2),
     dict(ctc_posterior=False, do_psd=True)),
)


def enc_batch(torch, dev, n: int, seconds, vocab: int, seed: int, infeasible: int = -1):
    """Encoder training inputs: ``n`` seeded utterances of ``seconds``
    through the eval front end (no CMVN) on ``dev``; ENC_RICH then encoder-
    vocabulary targets, a third as many as the row's frames (row
    ``infeasible``: 5 more targets than frames).  Returns (features fp32,
    lengths, text, text lengths, audio seconds)."""
    import numpy as np

    from ps_slm_tpu_torch.config import FbankConfig
    from ps_slm_tpu_torch.ops.fbank import frontend

    rng = np.random.default_rng(seed)
    lens = rng.integers(int(seconds[0] * 16000), int(seconds[1] * 16000) + 1, size=n)
    wave = np.zeros((n, int(lens.max())), np.float32)
    for i, m in enumerate(lens):
        wave[i, :m] = 0.1 * rng.normal(size=m)
    feats, flens = frontend(torch.from_numpy(wave).to(dev), torch.from_numpy(lens).to(dev),
                            cfg=FbankConfig(), cmvn=None, train=False)
    n_tok = [max(int(f) // 3, 1) for f in flens.tolist()]
    if infeasible >= 0:
        n_tok[infeasible] = int(flens[infeasible]) + 5
    text = np.zeros((n, 4 + max(n_tok)), np.int64)
    text[:, :4] = ENC_RICH
    for i, m in enumerate(n_tok):
        text[i, 4:4 + m] = rng.integers(1, vocab, size=m)
    return (feats, flens, torch.from_numpy(text).to(dev),
            torch.tensor([4 + m for m in n_tok], device=dev), float(lens.sum()) / 16000)


def encoder_step(torch, enc, tc, feats, flens, text, tlens):
    """The encoder training step of benchmarks/tasu_transfer.py: the
    queries prepended, ``encoder_train_loss``, AdamW with warmup-cosine
    (the port's train_state).  Returns (step, its MultiSteps)."""
    from ps_slm_tpu_torch.models import sensevoice_asr as asr
    from ps_slm_tpu_torch.training.train_state import MultiSteps, build_optimizer, warmup_cosine

    accum = MultiSteps(build_optimizer(enc.parameters(), tc),
                       warmup_cosine(tc.lr, tc.warmup_steps, tc.total_steps))

    def step():
        accum.optimizer.zero_grad(set_to_none=True)
        x, lens = asr.prepend_queries(enc, feats, flens, ENC_QUERIES)
        out = asr.encoder_train_loss(enc, x, lens, text, tlens)
        out["loss"].backward()
        accum.step()
        return {k: v.detach() for k, v in out.items()}

    return step, accum


class IdText:
    """A tokenizer whose text is the ids themselves (12a compares ids)."""

    @staticmethod
    def decode(ids):
        return ",".join(str(int(i)) for i in ids)


def encoder_fp32_run(device) -> tuple:
    """12a's encoder on ``device`` (built on the CPU from its seed, its CTC
    head x HEAD_SCALE): the inference results, the infeasible batch's
    losses and gradients, the feasible steps' losses, changes, first
    moments and gradients (on the CPU), and the two batches' lengths."""
    import torch

    from ps_slm_tpu_torch.config import SENSEVOICE_SMALL, TrainConfig
    from ps_slm_tpu_torch.models import sensevoice_asr as asr
    from ps_slm_tpu_torch.models.sensevoice import SenseVoiceConfig, SenseVoiceEncoder

    cfg = SenseVoiceConfig(**dict(SENSEVOICE_SMALL, num_blocks=2, tp_blocks=1))
    enc = SenseVoiceEncoder(cfg)
    enc.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        enc.ctc_lo.weight.mul_(HEAD_SCALE)
        enc.ctc_lo.bias.mul_(HEAD_SCALE)
    enc = enc.to(device)
    cpu = torch.device("cpu")
    asr_in = enc_batch(torch, cpu, 4, (1.0, 3.0), cfg.vocab_size, seed=6)
    results = asr.inference(enc, IdText(), asr_in[0], asr_in[1], language="en",
                            ban_emo_unk=True, output_timestamp=True, device=device)
    tc = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    feasible = enc_batch(torch, cpu, 4, (1.0, 3.0), cfg.vocab_size, seed=5)[:4]
    infeasible = enc_batch(torch, cpu, 4, (1.0, 3.0), cfg.vocab_size, seed=5, infeasible=3)[:4]
    start = {n: p.detach().clone() for n, p in enc.named_parameters()}
    # the infeasible batch: one backward, its losses and gradients
    step, accum = encoder_step(torch, enc, tc, *(x.to(device) for x in infeasible))
    accum.step = lambda: True                 # the gradients stay, nothing moves
    out = {k: float(v) for k, v in step().items()}
    grads = (out, {n: p.grad.detach().cpu() for n, p in enc.named_parameters()})
    rows = [x.to(device) for x in feasible]
    step, accum = encoder_step(torch, enc, tc, *rows)
    losses, step_grads = [], []
    for _ in range(ENC_FP32_STEPS):
        losses.append({k: float(v) for k, v in step().items()})
        step_grads.append({n: p.grad.detach().cpu() for n, p in enc.named_parameters()})
    with torch.no_grad():                     # the loss after the update
        x, lens = asr.prepend_queries(enc, rows[0], rows[1], ENC_QUERIES)
        losses.append({k: float(v) for k, v in
                       asr.encoder_train_loss(enc, x, lens, rows[2], rows[3]).items()})
    state = accum.optimizer.state
    run = (losses, {n: (p.detach() - start[n]).cpu() for n, p in enc.named_parameters()},
           {n: state[p]["exp_avg"].cpu() for n, p in enc.named_parameters()}, step_grads)
    return results, grads, run, feasible[1], infeasible[1]


def phase_encoder_fp32(torch, dev, ref) -> None:
    """12a, the encoder: full widths at 2+1 blocks, fp32, card
    (:func:`encoder_fp32_run`) against ``ref``, the CPU's run from the same
    weights: ``inference`` with timestamps on 4
    utterances (the same ids and timestamps); one backward on a ragged
    4-row batch with rich labels and an infeasible row (losses within
    PATH_TOL of the CPU's, relative to their size; each parameter's
    gradient within 1e-2 of its largest element: the infeasible row's fp32
    gradient is ill-conditioned, tests/test_torch_ctc.py); then
    ENC_FP32_STEPS AdamW steps on the same rows, all feasible, the first
    at the warm-up's learning rate 0, so both gradients are taken at the
    start and one update is made, then the loss after that update (a
    forward alone): every loss within PATH_TOL, each step's gradients and
    AdamW's first moments within MOMENT_TOL of each tensor's largest, and
    each parameter's change (trained minus start) within MOVE_TOL of its
    size as ||change card - change CPU|| / ||change CPU||, tensor by tensor,
    with the elements whose gradient is rounding noise left out and shown:
    those whose CPU gradient is below GRAD_FLOOR of the tensor's largest
    and differs on the card by more than GRAD_FLOOR of itself.  Adam's
    update is about g / |g| a step, so an element whose gradient is 0 up
    to rounding (the key third of each ``qkv`` bias: softmax ignores a
    shift shared by every key) steps by its normalised rounding noise,
    which differs between the devices.  So a second update, or a gradient
    taken after the first, is no longer a like-for-like comparison: the
    parameters already differ in those elements by up to 2 lr."""
    what = "encoder fp32"
    t0 = time.time()
    results, grads, runs = {}, {}, {}
    results["cuda"], grads["cuda"], runs["cuda"], feasible, infeasible = encoder_fp32_run(dev)
    results["cpu"], grads["cpu"], runs["cpu"], _, _ = ref.result()
    if results["cpu"] != results["cuda"]:
        fail(f"{what}: inference differs card vs CPU: {results['cuda']} / {results['cpu']}")
    n_ts = sum(len(r["timestamp"]) for r in results["cuda"])
    (l_c, d_c, m_c, sg_c), (l_g, d_g, m_g, sg_g) = runs["cpu"], runs["cuda"]
    (o_c, g_c), (o_g, g_g) = grads["cpu"], grads["cuda"]
    loss_err = max(abs(a[k] - b[k]) / max(1.0, abs(b[k])) for a, b in zip(l_g + [o_g], l_c + [o_c])
                   for k in ("loss_ctc", "loss_rich"))

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    moment_err = max(rel(m_g[n], m_c[n]) for n in m_c)
    step_grad_err = max(rel(sg_g[i][n], sg_c[i][n]) for i in range(ENC_FP32_STEPS) for n in m_c)
    grad_err = max(rel(g_g[n], g_c[n]) for n in g_c)
    # left out: the elements whose CPU gradient is below GRAD_FLOOR of the
    # tensor's largest and off on the card by more than GRAD_FLOOR of itself
    # at some step, which is a gradient that is rounding noise
    kept = {n: torch.stack([(gc[n].abs() >= GRAD_FLOOR * gc[n].abs().max())
                            | ((gg[n] - gc[n]).abs() <= GRAD_FLOOR * gc[n].abs())
                            for gc, gg in zip(sg_c, sg_g)]).all(0) for n in d_c}
    moves = sorted(((float((d_g[n] - d_c[n])[kept[n]].norm())
                     / max(float(d_c[n][kept[n]].norm()), 1e-30), n) for n in d_c), reverse=True)
    move_err = moves[0][0]
    left_out = {n: 1.0 - float(kept[n].float().mean()) for n in d_c}
    worst = sorted(left_out, key=left_out.get, reverse=True)[:3]
    # what was left out: its largest CPU gradient over all steps, against the tensor's largest
    left_grad = {n: max(float(torch.where(kept[n], 0.0, g[n].abs()).max())
                        / max(float(g[n].abs().max()), 1e-30) for g in sg_c) for n in worst}
    still = [n for n in d_c if not bool(d_c[n].any())]
    print(f"{what} 12a (2+1 blocks, full width, 4 ragged rows of {feasible.tolist()} "
          f"frames): losses card {l_g} cpu {l_c} (the last after an update); with row 3 "
          f"infeasible ({infeasible.tolist()} frames) card {o_g} cpu {o_c}; loss err "
          f"{loss_err:.3e} (relative, tol {PATH_TOL}); after {ENC_FP32_STEPS} AdamW steps the "
          f"gradients within {step_grad_err:.3e} and the first moments within {moment_err:.3e} "
          f"of their size (tol {MOMENT_TOL}); each parameter's change within {move_err:.3e} of "
          f"its size (tol {MOVE_TOL}; the largest: {[(n, round(e, 6)) for e, n in moves[:3]]}) "
          f"leaving out the elements whose gradient is below {GRAD_FLOOR} of the tensor's "
          f"largest and off card vs CPU by more than {GRAD_FLOOR} of itself; left out the most: "
          f"{[(n, round(left_out[n], 4)) for n in worst]}, their gradients at most "
          f"{[(n, float('%.3e' % left_grad[n])) for n in worst]} of the tensor's largest; "
          f"the infeasible batch's gradients within {grad_err:.3e} of each tensor's largest "
          f"(tol 1e-2); unmoved {still}; inference: {n_ts} timestamps, ids and timestamps "
          f"equal ({time.time() - t0:.1f} s)", flush=True)
    if (loss_err > PATH_TOL or moment_err > MOMENT_TOL or step_grad_err > MOMENT_TOL
            or move_err > MOVE_TOL or grad_err > 1e-2 or still or n_ts == 0):
        fail(f"{what}: card and CPU disagree, or a parameter did not move ({still})")
    if not o_g["loss_ctc"] > 1e4:
        fail(f"{what}: the infeasible row's loss is not optax's finite ~1e5 / 4")


def branch_configs(label: str, base_tc, base_mc):
    """The (train, model) configs of PROJECTOR_RUNS' ``label`` over a base."""
    import dataclasses

    _, name, mcfg, flags = next(r for r in PROJECTOR_RUNS if r[0] == label)
    return (dataclasses.replace(base_tc, **flags),
            dataclasses.replace(base_mc, encoder_projector=name, **mcfg))


def projectors_fp32_run(device) -> dict:
    """12a's projectors on ``device``: by PROJECTOR_RUNS' label, the merged
    embeddings, mask and positions, the step's loss and the trained
    parameters' AdamW first moments, on the CPU."""
    import torch

    from ps_slm_tpu_torch.config import SENSEVOICE_SMALL, half_audio_configs
    from ps_slm_tpu_torch.models import projector as proj
    from ps_slm_tpu_torch.models.tasu import TasuFlags, model_factory, prepare_merged
    from ps_slm_tpu_torch.training.step import make_train_step

    base_tc, base_mc = half_audio_configs(*FP32_DEPTH, seed=0)
    model = model_factory(base_tc, base_mc, device="cpu").to(device)
    model.speech_token_id = SPEECH_TOKEN
    batch = train_batch(torch, SENSEVOICE_SMALL["input_size"], PROJECTOR_FP32_FRAMES, seed=5)
    out = {}
    for label, *_ in PROJECTOR_RUNS:
        tc, mc = branch_configs(label, base_tc, base_mc)
        projector = proj.build_projector(mc)
        projector.init_weights(torch.Generator().manual_seed(7))
        model.projector = projector.to(device)
        model.model_cfg, model.flags = mc, TasuFlags.from_train_config(tc, mc)
        bd = {k: v.to(device) for k, v in batch.items()}
        with torch.no_grad():
            merged = prepare_merged(model, bd)
        step = make_train_step(model, tc, device=device)
        loss = float(step(bd)["loss"])
        params = dict(model.named_parameters())
        out[label] = (merged.embeds.cpu(), merged.attention_mask.cpu(),
                      merged.position_ids.cpu(), loss,
                      {n: step.optimizer.state[params[n]]["exp_avg"].cpu()
                       for n in step.trainable})
        del step, merged
    return out


def phase_projectors_fp32(torch, dev, ref) -> None:
    """12a, the projectors and branches: full widths at 2+1 encoder blocks
    and 1 LLM layer, fp32, card (:func:`projectors_fp32_run`) against
    ``ref``, the CPU's run: one model built from its seed on each, then
    each of PROJECTOR_RUNS' projectors (drawn on the CPU) with its flags (projector trained, encoder
    and LLM frozen) on a ragged 2-row batch (PROJECTOR_FP32_FRAMES):
    ``prepare_merged`` within PATH_TOL (masks and positions equal), then
    one training step: its loss within PATH_TOL and the trained
    parameters' AdamW first moments (their gradients through the LLM)
    within PROJ_MOMENT_TOL as ||card - CPU|| / ||CPU||, tensor by tensor,
    that norm floored at GRAD_FLOOR of the projector's largest (a tensor
    whose gradient is smaller is rounding-limited: the q-former's key
    biases).  A norm, not the largest element: a ReLU input within
    rounding of 0 takes one frame of one unit out of the gradient on one
    device only."""
    from ps_slm_tpu_torch.config import SENSEVOICE_SMALL

    t0 = time.time()
    runs = projectors_fp32_run(dev)
    ref_runs = ref.result()
    batch = train_batch(torch, SENSEVOICE_SMALL["input_size"], PROJECTOR_FP32_FRAMES, seed=5)
    for label, *_ in PROJECTOR_RUNS:
        (e_c, a_c, p_c, l_c, mom_c), (e_g, a_g, p_g, l_g, mom_g) = ref_runs[label], runs[label]
        # ||card - CPU|| / ||CPU|| a tensor, the norm floored at GRAD_FLOOR of
        # the projector's largest: the q-former's key biases (0 up to rounding)
        # and its cross-attention (which the near-uniform posterior frames
        # barely steer) sit below it
        floor = GRAD_FLOOR * max(float(m.norm()) for m in mom_c.values())
        mom_err = max(float((mom_g[n] - mom_c[n]).norm()) / max(float(mom_c[n].norm()), floor,
                                                               1e-30) for n in mom_c)
        floored = [n for n in mom_c if float(mom_c[n].norm()) < floor]
        same = torch.equal(a_c, a_g) and torch.equal(p_c, p_g)
        emb_err = float((e_c - e_g).abs().max())
        print(f"projectors fp32 12a {label}: embeds err {emb_err:.3e}, loss card {l_g:.6f} cpu "
              f"{l_c:.6f} (tol {PATH_TOL}); the first moments of {len(mom_c)} trained tensors "
              f"within {mom_err:.3e} of their norm (tol {PROJ_MOMENT_TOL}; {len(floored)} sized at "
              f"the floor, {GRAD_FLOOR} of the largest: {floored[:3]}); merged length "
              f"{e_g.shape[1]}, audio spans "
              f"{(a_g.sum(1) - batch['attention_mask'].sum(1) + 1).tolist()}", flush=True)
        if (not same or emb_err > PATH_TOL or abs(l_g - l_c) > PATH_TOL
                or mom_err > PROJ_MOMENT_TOL or not math.isfinite(l_g)):
            fail(f"projectors fp32 {label}: card and CPU disagree (masks equal {same})")
    print(f"projectors fp32 12a: {time.time() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()


def phase_encoder_train(torch, dev, launches: dict) -> dict:
    """12b: SenseVoiceSmall (50 + 20 blocks) trained alone at full width,
    bf16, random weights from seed 42, on ENC_UTTS utterances of
    ENC_SECONDS through the front end: ENC_WARMUP + ENC_STEPS timed steps
    on the same batch (remat off) with exact launches a step by route,
    then one profiled step, one step with remat, and a step repeated from
    one saved state.  Returns phase 3's cases at its shapes."""
    import statistics

    from ps_slm_tpu_torch.config import SENSEVOICE_SMALL, TrainConfig
    from ps_slm_tpu_torch.models.sensevoice import SenseVoiceConfig, SenseVoiceEncoder
    from ps_slm_tpu_torch.utils.flops import sensevoice_matmul_flops

    what = "encoder training"
    counters = kernel_counters()
    cfg = SenseVoiceConfig(**SENSEVOICE_SMALL)
    with torch.device("meta"):
        enc = SenseVoiceEncoder(cfg)
    enc = enc.to(dtype=torch.bfloat16).to_empty(device=dev)
    enc.init_weights(torch.Generator(device=dev).manual_seed(42))
    feats, flens, text, tlens, audio_s = enc_batch(torch, dev, ENC_UTTS, ENC_SECONDS,
                                                   cfg.vocab_size, seed=42)
    feats = feats.to(torch.bfloat16)
    tc = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=1000)
    step, accum = encoder_step(torch, enc, tc, feats, flens, text, tlens)
    t_len = feats.shape[1] + len(ENC_QUERIES)
    losses, times = [], []
    for _ in range(ENC_WARMUP):
        losses.append(float(step()["loss"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = with_routes(LAUNCHES_PER_ENC_STEP, LN_ROUTES_ENC,
                       ln_bwd_vec=LAUNCHES_PER_ENC_STEP["layer_norm_bwd"])
    for i in range(ENC_STEPS):
        reset_counters(counters)
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        got = launch_counts(counters)
        if got != want:
            fail(f"{what}: step {i + 1} launched {nonzero(got)}, not {nonzero(want)}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        losses.append(float(out["loss"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"{what}: losses {losses} not finite or not falling")
    ms = statistics.median(times)
    flops = 3 * sensevoice_matmul_flops(cfg, t_len, ENC_UTTS)["total"]
    prof = profiled(torch, step, kernels=("layer_norm_bwd", "partial_sum_kernel"))
    ln_bwd = [(ms, n) for name, ms, n in prof[3]
              if "layer_norm_bwd" in name or "partial_sum_kernel" in name]
    print(f"{what} 12b (SenseVoiceSmall, 50 + 20 blocks, bf16, {ENC_UTTS} utterances of "
          f"{audio_s:.2f} s, {flens.tolist()} frames + 4 queries): step {ms:.2f} ms (min "
          f"{min(times):.2f}, max {max(times):.2f}); {audio_s / ms * 1e3:.1f} audio-s/s; "
          f"{mfu(flops, ms, dev)} ({flops / 1e12:.3f} TFLOP a step: "
          f"forward + 2x backward); peak memory {peak:.2f} GB; losses "
          f"{[round(x, 3) for x in losses]}; launches a step {nonzero(want)} [{CARD}]",
          flush=True)
    print_profiled(f"{what} step", prof)
    if prof[1] is not None:
        ms_ln = sum(ms for ms, _ in ln_bwd)
        print(f"{what} 12b: the LayerNorm backward (kernel and dw/db sum) {ms_ln:.3f} ms of the "
              f"profiled step's {prof[1]:.2f} ms device time ({ms_ln / prof[1]:.3f}), "
              f"{sum(n for _, n in ln_bwd)} launches [{CARD}]", flush=True)

    # one step with remat: the 69 blocks after encoders0 run their forward again
    again = cfg.num_blocks - 1 + cfg.tp_blocks
    enc.remat = True
    torch.cuda.reset_peak_memory_stats()
    reset_counters(counters)
    t0 = time.perf_counter()
    out = step()
    torch.cuda.synchronize()
    remat_ms = (time.perf_counter() - t0) * 1e3
    want_remat = dict(LAUNCHES_PER_ENC_STEP, flash_attention_fwd=70 + again,
                      layer_norm_fwd=142 + 2 * again)
    want_remat = with_routes(want_remat, dict(LN_ROUTES_ENC, vec=142 + 2 * again),
                             ln_bwd_vec=LAUNCHES_PER_ENC_STEP["layer_norm_bwd"])
    got = launch_counts(counters)
    if got != want_remat or not math.isfinite(float(out["loss"])):
        fail(f"{what}: the remat step launched {nonzero(got)}, not {nonzero(want_remat)}")
    print(f"{what} 12b remat: step {remat_ms:.2f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (off: {peak:.2f}) [{CARD}]",
          flush=True)
    enc.remat = False

    # the same step twice from one saved state
    state = ({n: p.detach().clone() for n, p in enc.named_parameters()},
             copy.deepcopy(accum.state_dict()))

    def from_state():
        with torch.no_grad():
            for n, p in enc.named_parameters():
                p.copy_(state[0][n])
        accum.load_state_dict(copy.deepcopy(state[1]))
        loss = float(step()["loss"])
        return loss, {n: p.detach().clone() for n, p in enc.named_parameters()}

    def spread(a, b):
        return max(float((a[1][n].float() - b[1][n].float()).abs().max()) for n in a[1])

    first, second = from_state(), from_state()
    same = first[0] == second[0] and spread(first, second) == 0.0
    note = "bit-identical"
    if not same:
        note = (f"differ: loss {first[0]} / {second[0]}, weights {spread(first, second):.3e} "
                "apart")
        torch.backends.cudnn.deterministic = True
        third, fourth = from_state(), from_state()
        torch.backends.cudnn.deterministic = False
        note += (f"; with cudnn.deterministic {'bit-identical' if third[0] == fourth[0] and spread(third, fourth) == 0.0 else 'still %.3e apart' % spread(third, fourth)}"
                 " (the FSMN's depthwise conv1d weight gradient is cuDNN's)")
    print(f"{what} 12b: one step twice from a saved state: {note}", flush=True)
    rows = ENC_UTTS * t_len
    cases = {
        "flash": [("encoder train", ENC_UTTS, t_len, cfg.attention_heads, cfg.attention_heads,
                   False, [0] * ENC_UTTS, [int(x) + 4 for x in flens.tolist()])],
        "norm": [("layer_norm_fwd", rows, cfg.input_size, None),
                 ("layer_norm_fwd", rows, cfg.output_size, None)],
        "norm_bwd": [("layer_norm_bwd", rows, cfg.input_size, None),
                     ("layer_norm_bwd", rows, cfg.output_size, None)],
    }
    del enc, state, first, second, step, accum
    torch.cuda.empty_cache()
    return cases


def phase_asr(torch, dev, launches: dict) -> None:
    """12c: standalone rich-label ASR at full width, bf16: a funasr
    SenseVoiceSmall directory written from seed 42 (CTC head as wide as its
    BPE model) and loaded back, phase 6's 32 utterances (its manifest
    writer and seed) read and put through the front end with the
    directory's am.mvn, ``inference`` with timestamps in batches of
    ASR_BATCH.  Exact launches a call (flash 70, LayerNorm 142 vec), the
    second pass's ids bit-identical to the first's; wall, audio-s/s and
    the Viterbi's share of the wall."""
    import numpy as np

    from ps_slm_tpu_torch.config import SENSEVOICE_SMALL, FbankConfig
    from ps_slm_tpu_torch.data import audio_io
    from ps_slm_tpu_torch.data.spm import SenseVoiceTokenizer
    from ps_slm_tpu_torch.models import sensevoice_asr as asr
    from ps_slm_tpu_torch.models.sensevoice import SenseVoiceConfig, SenseVoiceEncoder
    from ps_slm_tpu_torch.ops.fbank import frontend, load_cmvn
    from ps_slm_tpu_torch.training.checkpoint import load_funasr_encoder

    what = "standalone ASR"
    counters = kernel_counters()
    root = tempfile.mkdtemp(prefix="asr_")
    try:
        with torch.device("meta"):
            src = SenseVoiceEncoder(SenseVoiceConfig(**SENSEVOICE_SMALL))
        src = src.to_empty(device=dev)
        src.init_weights(torch.Generator(device=dev).manual_seed(42))
        enc_dir = os.path.join(root, "SenseVoiceSmall")
        write_encoder_dir(enc_dir, src)
        write_bpe_model(enc_dir, vocab=SENSEVOICE_SMALL["vocab_size"])
        del src
        audio_s = write_manifest(os.path.join(root, "test"), None, DECODE_SECONDS, seed=0)
        state, cfg = load_funasr_encoder(enc_dir)
        with torch.device("meta"):
            enc = SenseVoiceEncoder(cfg)
        enc = enc.to(dtype=torch.bfloat16).to_empty(device=dev)
        enc.load_state_dict(state)
        cmvn = tuple(torch.as_tensor(v, dtype=torch.float32, device=dev)
                     for v in load_cmvn(os.path.join(enc_dir, "am.mvn")))
        tok = SenseVoiceTokenizer(enc_dir)
        with open(os.path.join(root, "test", "multitask.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        waves = [audio_io.load_audio(r["path"]) for r in rows]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    batches = []
    for i in range(0, len(waves), ASR_BATCH):
        group = waves[i:i + ASR_BATCH]
        lens = np.array([len(w) for w in group])
        pad = np.zeros((len(group), lens.max()), np.float32)
        for j, w in enumerate(group):
            pad[j, :len(w)] = w
        batches.append((torch.from_numpy(pad).to(dev), torch.from_numpy(lens).to(dev),
                        [r["key"] for r in rows[i:i + ASR_BATCH]]))
    align_s = []
    real_align = asr.ctc_forced_align

    def timed_align(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_align(*args, **kwargs)
        torch.cuda.synchronize()
        align_s.append(time.perf_counter() - t)
        return out

    def run():
        out = []
        for wave, lens, keys in batches:
            feats, flens = frontend(wave, lens, cfg=FbankConfig(), cmvn=cmvn, train=False)
            reset_counters(counters)
            out += asr.inference(enc, tok, feats.to(torch.bfloat16), flens, output_timestamp=True,
                                 ban_emo_unk=True, keys=keys)
            got = launch_counts(counters)
            want = with_routes(dict(LAUNCHES_PER_ENC_STEP, flash_attention_dq=0,
                                    flash_attention_dkv=0, layer_norm_bwd=0), LN_ROUTES_ENC)
            if got != want:
                fail(f"{what}: a call launched {nonzero(got)}, not {nonzero(want)}")
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
        return out

    asr.ctc_forced_align = timed_align
    try:
        run()                                     # warm-up
        torch.cuda.synchronize()
        align_s.clear()
        t0 = time.perf_counter()
        first = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        align = sum(align_s)
        second = run()
    finally:
        asr.ctc_forced_align = real_align
    if [r["text"] for r in first] != [r["text"] for r in second] or first != second:
        fail(f"{what}: two passes gave other texts or timestamps")
    n_tok = sum(len(r["timestamp"]) for r in first)
    print(f"{what} 12c ({len(first)} utterances, {audio_s:.2f} s, batches of {ASR_BATCH}, bf16, "
          f"timestamps on): wall {wall:.3f} s, {audio_s / wall:.1f} audio-s/s, the Viterbi "
          f"{align:.3f} s ({align / wall:.3f} of the wall), {n_tok} timestamped tokens; two "
          f"passes identical; first text {first[0]['text'][:60]!r} [{CARD}]", flush=True)
    del enc
    torch.cuda.empty_cache()


def projector_launches(label: str) -> dict:
    """A projector-trained step's launches by route on phase 5's model."""
    per = dict(LAUNCHES_PER_TRAIN_STEP, layer_norm_fwd=LN_PER_GENERATE - 1, layer_norm_bwd=0)
    vec = LN_PER_GENERATE - 1
    if label == "q-former":               # its 768- and 1536-wide norms, all vectorised
        per.update(layer_norm_fwd=vec + QF_NORMS, layer_norm_bwd=QF_NORMS)
        vec += QF_NORMS
    if label == "voca_trans top1":        # the argmax passes no gradient: no backward
        per.update(flash_attention_dq=0, flash_attention_dkv=0, rms_norm_bwd=0)
    return with_routes(per, {"vec": vec, "staged": 0, "held": 0, "general": 0},
                       ln_bwd_vec=per["layer_norm_bwd"])


def phase_projectors(torch, dev, model, launches: dict) -> dict:
    """12d: each of PROJECTOR_RUNS swapped into phase 5's bf16 model
    (SenseVoiceSmall + Qwen2.5-1.5B, random weights): 3 training steps of
    ``make_train_step`` (projector trained) with exact launches by route,
    step ms and peak memory; one greedy ``generate`` of phase 5's batch,
    bit-identical twice; the cross-attention projector's chunked softmax
    over the 151 936 embedding rows timed alone.  Adds the launches to
    ``launches`` by label; returns a step's launches by label."""
    import statistics

    from ps_slm_tpu_torch.config import SENSEVOICE_SMALL, half_audio_configs
    from ps_slm_tpu_torch.inference.generate import generate
    from ps_slm_tpu_torch.models import projector as proj
    from ps_slm_tpu_torch.models.tasu import TasuFlags, encode_speech
    from ps_slm_tpu_torch.ops.psd import psd
    from ps_slm_tpu_torch.training.step import make_train_step

    counters = kernel_counters()
    base_tc, base_mc = half_audio_configs()
    batch = train_batch(torch, SENSEVOICE_SMALL["input_size"], FRAMES, seed=2)
    batch["input_features"] = batch["input_features"].to(torch.bfloat16)
    serve = {k: v for k, v in batch.items() if k != "labels"}
    saved = (model.projector, model.model_cfg, model.flags)
    per_label = {}
    try:
        for label, *_ in PROJECTOR_RUNS:
            tc, mc = branch_configs(label, base_tc, base_mc)
            with torch.device("meta"):
                p = proj.build_projector(mc)
            model.projector = p.to(dtype=torch.bfloat16).to_empty(device=dev)
            model.projector.init_weights(torch.Generator(device=dev).manual_seed(7))
            model.model_cfg, model.flags = mc, TasuFlags.from_train_config(tc, mc)
            step = make_train_step(model, tc)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times, losses = [], []
            want = projector_launches(label)
            for i in range(3):
                reset_counters(counters)
                t0 = time.perf_counter()
                losses.append(float(step(batch)["loss"]))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                got = launch_counts(counters)
                if got != want:
                    fail(f"projectors 12d {label}: step {i + 1} launched {nonzero(got)}, not "
                         f"{nonzero(want)}")
                for k, v in got.items():
                    launches[k] = launches.get(k, 0) + v
            per_label[label] = got
            peak = torch.cuda.max_memory_allocated() / 1e9
            n_params = sum(x.numel() for x in model.projector.parameters())
            del step
            tokens = [generate(model, serve, eos_token_id=EOS, num_beams=1,
                               max_new_tokens=MAX_NEW).cpu() for _ in range(2)]
            if not torch.equal(tokens[0], tokens[1]) or not all(map(math.isfinite, losses)):
                fail(f"projectors 12d {label}: generate not bit-identical, or losses {losses}")
            extra = ""
            if label == "cross-attention":
                with torch.no_grad():
                    bd = {k: v.to(dev) for k, v in serve.items()}
                    _, post, lens = encode_speech(model.encoder, bd["input_features"],
                                                  bd["input_feature_length"])
                    feats, _ = psd(post, lens, post, blank_id=0)
                    table = model.llm.embed_tokens.weight
                    ca_ms = time_ms(torch, lambda: model.projector(feats, table), iters=3)
                extra = (f"; the chunked softmax over {table.shape[0]} rows at "
                         f"{tuple(feats.shape[:2])} frames: {ca_ms:.3f} ms device time")
            print(f"projectors 12d {label}: {n_params} parameters; step "
                  f"{statistics.median(times):.2f} ms ({[round(t, 1) for t in times]}); peak "
                  f"memory {peak:.2f} GB; losses {[round(x, 4) for x in losses]}; launches a step "
                  f"{nonzero(got)}; generate bit-identical twice{extra} [{CARD}]", flush=True)
            model.projector = None
            torch.cuda.empty_cache()
    finally:
        model.projector, model.model_cfg, model.flags = saved
    return per_label


def write_chain_assets(torch, root: str) -> tuple:
    """Phase 7's assets under ``root``: phase 6's writers on a seed-42 fp32
    model (bf16 LLM), a character BPE model beside the encoder, train and
    dev manifests.  Returns (assets, audio seconds by split, model config)."""
    from ps_slm_tpu_torch.config import half_audio_configs
    from ps_slm_tpu_torch.models.tasu import model_factory

    tc, mc = half_audio_configs()
    src = model_factory(tc, mc)                  # fp32 on the card, seed 42
    assets = write_assets(root, src, llm_dtype=torch.bfloat16,
                          utts=CHAIN_UTTS["test"])
    del src
    torch.cuda.empty_cache()
    write_bpe_model(assets["encoder_path"])
    audio = {split: write_manifest(os.path.join(root, split), CHAIN_UTTS[split],
                                   DECODE_SECONDS, seed=seed)
             for split, seed in (("train", 1), ("dev", 2))}
    return assets, audio, mc


def phase_qformer_cli(torch, dev, assets: dict, root: str, launches: dict,
                      interval: int) -> None:
    """12d through the CLI: scripts/finetune_half_audio.sh's overrides with
    ``encoder_projector=q-former`` (its defaults: 8 layers, 12 heads, 64
    queries) and no INIT checkpoint on phase 7's assets, one epoch validating every ``interval``
    steps (step_N checkpoints); the reference export must hold exactly the
    q-former's tensors under their HF names, and all of them load back."""
    from ps_slm_tpu_torch.cli import finetune
    from ps_slm_tpu_torch.training import checkpoint as ckpt

    what = "q-former finetune CLI"
    counters = kernel_counters()
    out = os.path.join(root, "exp", "half_audio_qformer")
    # no INIT: the recipe's linear-silu checkpoint names a "norm" the
    # q-former's output norm shares, at the posterior's width
    args = [a for a in finetune_args(assets, root, out) if not a.startswith("ckpt_path=")] + [
        "++model_config.encoder_projector=q-former", "++train_config.num_epochs=1",
        f"++train_config.validation_interval={interval}"]
    reset_counters(counters)
    with TrainProbe(torch, dev) as probe:
        t0 = time.perf_counter()
        if finetune.main(args) != 0:
            fail(f"{what}: main returned nonzero")
        wall = time.perf_counter() - t0
    for k, v in launch_counts(counters).items():
        launches[k] = launches.get(k, 0) + v
    tags = sorted(p for p in os.listdir(out) if p.startswith("step_"))
    if not tags or not all(math.isfinite(x) for x in probe.losses()):
        fail(f"{what}: checkpoints {tags}, losses {probe.losses()}")
    tensors = torch.load(os.path.join(out, tags[-1], "pytorch_model.bin"), weights_only=True)
    model = probe.model
    names = ckpt.projector_to_reference(model.projector, "q-former")
    if sorted(tensors) != sorted(names):
        fail(f"{what}: the export holds {len(tensors)} tensors, not the q-former's {len(names)}")
    state, loaded = ckpt.reference_to_projector(tensors, "q-former", model.projector)
    if len(loaded) != len(names):
        fail(f"{what}: {len(loaded)} of {len(names)} reference names loaded back")
    print(f"{what} 12d (scripts/finetune_half_audio.sh + encoder_projector=q-former, 1 epoch): "
          f"{probe.summary()}; export {tags[-1]}: {len(tensors)} q-former tensors under HF "
          f"names, all loaded back; main {wall:.1f} s [{CARD}]", flush=True)
    probe.model = probe.largest = None
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------------
# phase 13: the finetune CLI over several processes sharing the card (gloo)
# ----------------------------------------------------------------------------

def trained_moments(step) -> dict:
    """AdamW's first moment of each trained tensor of ``step`` (a
    ``TrainStep``), whole (a collective under FSDP2 / TP), on the CPU."""
    mesh = step.model.mesh
    params = dict(step.model.named_parameters())
    out = {}
    for n in step.trainable:
        m = step.optimizer.state[params[n]]["exp_avg"]
        out[n] = (m.detach() if mesh is None else mesh.whole(n, m)).cpu().clone()
    return out


def capture_trained(torch, store: dict):
    """Wraps ``training.loop.train`` so that, when a run's loop ends (its
    process group still up), the trained projector is gathered whole on
    every rank (a collective) and kept in ``store["projector"]`` on the
    CPU, and ``TrainStep.__call__`` so that AdamW's first moments after
    micro-step MOMENT_STEP are kept in ``store["moments"]``, by projector
    parameter name (:func:`trained_moments`); returns the undo.  Lets
    phase 13 compare what a run trained without writing checkpoints."""
    from ps_slm_tpu_torch.parallel import mesh as meshlib
    from ps_slm_tpu_torch.training import loop
    from ps_slm_tpu_torch.training import step as step_mod

    real, real_call = loop.train, step_mod.TrainStep.__call__

    def train(model, *args, **kwargs):
        out = real(model, *args, **kwargs)
        with meshlib.gathered(model) if model.mesh is not None else contextlib.nullcontext():
            store["projector"] = {k: v.detach().cpu().clone()
                                  for k, v in model.projector.state_dict().items()}
        return out

    def call(self, *args, **kwargs):
        out = real_call(self, *args, **kwargs)
        if self.step == MOMENT_STEP:
            store["moments"] = {n[len("projector."):]: m for n, m in
                                trained_moments(self).items() if n.startswith("projector.")}
        return out

    loop.train, step_mod.TrainStep.__call__ = train, call

    def undo():
        loop.train, step_mod.TrainStep.__call__ = real, real_call

    return undo


def projector_errs(got: dict, want: dict, moments: dict) -> dict:
    """The trained projector ``got`` against ``want`` (the one-process run's):
    the largest gap over the elements whose one-process first moment
    (``moments``) is at least GRAD_FLOOR of its tensor's largest
    (``kept``), over the rest (``floored``) and their count; and the
    moments' largest gap over each tensor's largest (``moments``, when
    the run's own are given as ``got["moments"]``)."""
    kept = floored = 0.0
    n_floored = 0
    for k, w in want.items():
        d = (got[k] - w).abs()
        d[~d.isfinite()] = float("inf")
        m = moments.get(k)
        big = (m.abs() >= GRAD_FLOOR * m.abs().max()) if m is not None \
            else d.new_ones(d.shape).bool()
        kept = max(kept, float(d[big].max()) if bool(big.any()) else 0.0)
        if not bool(big.all()):
            floored = max(floored, float(d[~big].max()))
            n_floored += int((~big).sum())
    return {"kept": kept, "floored": floored, "n_floored": n_floored}


def moment_err(got: dict, want: dict) -> float:
    """The largest gap of each tensor's first moments over that tensor's
    largest magnitude, over the tensors of ``want``."""
    if sorted(got) != sorted(want):
        return float("inf")
    errs = [float((got[k] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for k, w in want.items()]
    return float("inf") if any(e != e for e in errs) else max(errs)


def rank13_worker(spec_path: str) -> None:
    """One process of phases 13a / 13b (``python3 chip_smoke.py --rank13
    spec.json``, started by :func:`launch_ranks`): :func:`run13` on the
    spec's runs whose ``procs`` hold this process, each in a process group
    of its own.  Prints one ``RANK13`` JSON line: those runs' records, and
    the seconds the process took to start (from the launch,
    ``PS_LAUNCH_T0``), to import torch and the port, and each run's
    wall."""
    import faulthandler

    import torch

    sys.path.insert(0, HERE)
    from ps_slm_tpu_torch.cli import finetune  # noqa: F401  (imported before the clock reads)

    # a rank still running near the launch's time limit shows where it waits
    faulthandler.dump_traceback_later(float(os.environ["PS_RANK_STACKS_S"]), exit=False)

    with open(spec_path) as f:
        spec = json.load(f)
    me = int(os.environ["PS_HOST_ID"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = dict(start_s=round(T_PROCESS - float(os.environ["PS_LAUNCH_T0"]), 2),
                   import_s=round(time.time() - T_PROCESS, 2))
    runs, started["run_s"] = run13(torch, [r for r in spec["runs"] if me in r["procs"]], me)
    print("RANK13 " + json.dumps({"rank": me, "runs": runs, "started": started}), flush=True)


def run13(torch, spec_runs: list, me: int = -1) -> tuple:
    """Each run of ``spec_runs`` through ``cli.finetune.main`` under
    :class:`TrainProbe`: launch process ``me`` as rank ``procs.index(me)``
    of the run's own process group (its port in ``PS_COORDINATOR``, its
    size in ``PS_NUM_HOSTS``), on card ``rank % count``; with ``me`` -1 in
    this process alone (13a's one-process runs, in the phase's own
    process).  Returns each run's record and wall seconds.  A record holds
    the run's global losses, evaluations, micro-steps (wall, launches,
    peak memory), the gradient sums' synchronised ms a micro-step, the
    parameter bytes this rank holds and the whole model's, the trained
    projector's largest gap to the run's ``projector`` file (when given),
    whether the frozen weights kept their bits (when the run asks) and the
    launch mismatches against phase 7b's micro-step (when it asks)."""
    from torch.distributed.tensor import DTensor

    from ps_slm_tpu_torch.cli import finetune
    from ps_slm_tpu_torch.parallel import mesh as meshlib
    from ps_slm_tpu_torch.training import step as step_mod

    real_sync, real_make = meshlib.Parallel.sync_grads, step_mod.make_train_step
    sync_ms: list = []

    def timed_sync(self, model):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real_sync(self, model)
        torch.cuda.synchronize()
        sync_ms.append((time.perf_counter() - t) * 1e3)

    def local(p):
        return (p.to_local() if isinstance(p, DTensor) else p).detach()

    def whole_bytes(model, name, p):
        """The bytes of parameter ``name`` in the one-process model."""
        mesh = model.mesh
        if mesh is not None and name in mesh.freed:
            return math.prod(mesh.freed[name]) * p.element_size()
        if mesh is not None and name in mesh.tp:
            return p.numel() * mesh.shape["tensor"] * p.element_size()
        return p.numel() * p.element_size()

    def resharded(model):
        """FSDP2's units back on their shards (a forward without a backward,
        the validation's, leaves the root's parameters gathered)."""
        from torch.distributed.fsdp import FSDPModule

        for m in model.modules():
            if isinstance(m, FSDPModule):
                m.reshard()

    meshlib.Parallel.sync_grads = timed_sync
    runs, walls = [], []
    try:
        for run in spec_runs:
            t_run = time.time()
            rank = run["procs"].index(me) if me >= 0 else 0
            if me >= 0:
                os.environ.update(PS_COORDINATOR=f"localhost:{run['port']}",
                                  PS_NUM_HOSTS=str(len(run["procs"])), PS_HOST_ID=str(rank))
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            info: dict = {}

            def make(model, tc, device="cuda"):
                st = real_make(model, tc, device=device)
                params = list(model.named_parameters())
                info["bytes"] = sum(local(p).numel() * p.element_size() for _, p in params)
                info["full_bytes"] = sum(whole_bytes(model, n, p) for n, p in params)
                if run.get("frozen"):
                    info["frozen"] = {n: local(p).cpu().clone() for n, p in params
                                      if n not in st.trainable}
                info["step"] = st
                return st

            step_mod.make_train_step = make
            undo = capture_trained(torch, info)
            sync_ms.clear()
            torch.cuda.reset_peak_memory_stats()
            try:
                with TrainProbe(torch, dev) as probe:
                    rc = finetune.main(run["args"])
            finally:
                step_mod.make_train_step = real_make
                undo()
            model = info["step"].model
            out = dict(tag=run["tag"], rc=rc, losses=probe.losses(),
                       evals=[e["loss"] for e in probe.evals], ms=[s["ms"] for s in probe.steps],
                       launches=[s["launches"] for s in probe.steps],
                       peak=torch.cuda.max_memory_allocated() / 1e9, sync_ms=list(sync_ms),
                       bytes=info["bytes"], full_bytes=info["full_bytes"],
                       mesh=None if model.mesh is None else model.mesh.shape)
            if run.get("save_projector"):
                torch.save({"projector": info["projector"], "moments": info["moments"]},
                           run["save_projector"])
            if run.get("compare"):
                for _ in range(600):        # a variant's: its one-process run's, beside
                    if os.path.exists(run["projector"]):
                        break
                    time.sleep(1.0)
                want = torch.load(run["projector"], weights_only=True)
                out["proj"] = projector_errs(info["projector"], want["projector"], want["moments"])
                out["moment_err"] = moment_err(info.get("moments", {}), want["moments"])
            if run.get("frozen"):
                resharded(model)
                params = dict(model.named_parameters())
                changed = [n for n, v in info.pop("frozen").items()
                           if not torch.equal(local(params[n]).cpu(), v)]
                out["frozen_same"], out["frozen_changed"] = not changed, changed[:4]
            if run.get("check"):
                want = with_routes(LAUNCHES_PER_TRAIN_STEP, LN_ROUTES_PER_PASS)
                out["launch_mismatch"] = [i for i, s in enumerate(probe.steps)
                                          if s["launches"] != want]
            if run.get("cases") and rank == 0:
                out["cases"] = finetune_cases(torch, dev, model, probe.largest[1],
                                              f"13b {run['tag']}")
            if run.get("save_batch") and rank == 0 and probe.largest is not None:
                torch.save({k: v.detach().cpu() for k, v in probe.largest[1].items()},
                           run["save_batch"])
            runs.append(out)
            probe.model = probe.largest = None
            del model, info
            torch.cuda.empty_cache()
            walls.append(round(time.time() - t_run, 1))
    finally:
        meshlib.Parallel.sync_grads = real_sync
    return runs, walls


def ephemeral_low() -> int:
    """The lowest port the kernel hands out to connections
    (``ip_local_port_range``; 32768, Linux's default, where it cannot be
    read)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def run_ports(runs: list, taken: set) -> None:
    """A port of its own for each run of ``runs`` that has none, free now
    and not in ``taken`` (which it joins), below the kernel's ephemeral
    range (which some hosts start as low as 16000): no connection takes it
    while the run waits its turn, and a rank that reaches the run before
    rank 0 listens cannot, while it retries, be given the port itself and
    connect to itself (a TCP self-connection, which hangs the
    rendezvous)."""
    import socket

    low = ephemeral_low()
    port = max(1024, min(20000, low) - 4000)
    for run in runs:
        while "port" not in run:
            port += 1
            if port >= low:
                raise RuntimeError(f"no free port below the ephemeral range ({low} up)")
            if port in taken:
                continue
            with socket.socket() as sock:
                try:
                    sock.bind(("localhost", port))
                except OSError:
                    continue
            run["port"] = port
            taken.add(port)


def launch_ranks(torch, n: int, runs: list, root: str, timeout: float, name: str) -> dict:
    """``runs`` (dicts of ``tag``, ``args``, ``procs`` and the worker's
    flags) in one launch of ``n`` processes sharing the card over gloo,
    its spec ``ranks<n>_<name>.json`` in ``root``: each process takes, in
    order, the runs whose ``procs`` (launch process indices, by rank)
    hold it, each run its own process group on a port of its own
    (:func:`run_ports`), whose rendezvous waits for all its processes.
    Returns every run's records by rank, by tag.  A process that fails
    fails the phase."""
    from ps_slm_tpu_torch.parallel.launch import launch

    run_ports(runs, {run["port"] for run in runs if "port" in run})
    spec = os.path.join(root, f"ranks{n}_{name}.json")
    with open(spec, "w") as f:
        json.dump({"runs": runs}, f)
    t0 = time.time()
    done = launch([sys.executable, os.path.join(HERE, "chip_smoke.py"), "--rank13", spec], n,
                  env={"PS_DIST_BACKEND": "gloo", "PYTHONPATH": HERE, "PS_LAUNCH_T0": repr(t0),
                       "PS_RANK_STACKS_S": repr(max(timeout - 20.0, 1.0))},
                  timeout=timeout, cwd=HERE)
    lines = [next((x for x in f.stdout.splitlines() if x.startswith("RANK13 ")), None)
             for f in done]
    if any(f.returncode != 0 or line is None for f, line in zip(done, lines)):
        fail(f"launch {name}: the processes exited {[f.returncode for f in done]}:\n" + "\n".join(
            f"process {f.rank} of {n}, exit {f.returncode}:\n{f.stdout[-1500:]}\n"
            f"{f.stderr[-4000:]}" for f in done))
    records = sorted((json.loads(line[len("RANK13 "):]) for line in lines),
                     key=lambda r: r["rank"])
    mine = [[run for run in runs if p in run["procs"]] for p in range(n)]
    out, walls = {}, {}
    for run in runs:
        at = [(p, mine[p].index(run)) for p in run["procs"]]
        out[run["tag"]] = [records[p]["runs"][i] for p, i in at]
        walls[run["tag"]] = records[at[0][0]]["started"]["run_s"][at[0][1]]
    print(f"launch {name}: {n} processes, wall {time.time() - t0:.1f} s; they started after "
          f"{[r['started']['start_s'] for r in records]} s and imported torch and the port in "
          f"{[r['started']['import_s'] for r in records]} s; each run's wall (its rank 0's) "
          f"{walls} s", flush=True)
    return out


def _mesh_tag(mesh: dict) -> str:
    return "+".join(f"{k}{v}" for k, v in mesh.items())


def phase_parallel_fp32(torch, dev, fp32: dict) -> dict:
    """Phase 13a: phase 4e's finetune CLI run (full width and reduced
    depth, its assets, recipe and 4 steps of 2 rows with validation every
    2, fp32, dither 0; ``fp32`` is what 4e returns: its card run is the
    one-process run) on each mesh of PARALLEL_GROUPS, in one launch of
    PARALLEL_PROCESSES processes sharing the card over gloo, each group of
    them running its runs one after another: every rank's losses the same
    bit for bit, the losses and
    evaluations within PARALLEL_TOL, AdamW's first moments after micro-step
    MOMENT_STEP within PARALLEL_MOMENT_TOL of each tensor's largest, and
    the trained projector (gathered when the loop ends) within
    PARALLEL_TOL where its moment is at least GRAD_FLOOR of the tensor's
    largest and PARALLEL_PROJ_TOL elsewhere, of the one-process run (a
    variant's, PARALLEL_VARIANTS: LoRA's, run in this process beside the
    launches); the frozen weights bit-identical.  The full-width runs
    write no checkpoint but PARALLEL_RESUME's (the card machine's disk
    takes a bounded amount of writes: a state is 1.6 GB), which writes
    ``step_2`` / ``step_4`` and is resumed from ``step_2``: its last two
    losses bit for bit, rank 0's ``step_4`` export as the trained
    projector.  Every mesh also trains a tiny model
    (:func:`tiny_finetune_args`, with the variant's overrides; its
    one-process run in this process) on 4e's manifests with checkpoints and
    resumes it from ``step_2``: the last losses bit for bit, and the rank
    files' tensors (each shard and replicated tensor written once) as many
    bytes as the one-process state's.  Deletes 4e's directory.  Returns
    the one-process model and the ranks' largest batches for phase 3's
    shard and microbatch rows."""
    from ps_slm_tpu_torch.training.checkpoint import _projector_keymap

    what = "parallel fp32"
    root, assets, mc = fp32["root"], fp32["assets"], fp32["mc"]
    extra = [a for a in fp32["extra"] if not a.startswith("++train_config.save_last=")]

    def args(out, mesh=None, save=False, resume=None, variant=""):
        a = finetune_args(assets, root, out, llm_dim=mc.llm_dim,
                          encoder_dim=mc.encoder_dim) + extra + PARALLEL_VARIANTS[variant]
        a += [f"++train_config.save_model={str(save).lower()}"]
        if mesh is not None:
            a += ["++train_config.mesh_shape=" + json.dumps(mesh)]
        if resume:
            a += [f"++train_config.resume_from={resume}"]
        return a

    def tiny_args(out, mesh=None, resume=None, variant=""):
        return tiny_finetune_args(root, out, mesh, resume) + PARALLEL_VARIANTS[variant]

    def full_runs(mesh, variant, tag):
        out = os.path.join(root, tag)
        save = mesh == PARALLEL_RESUME and not variant
        runs = [dict(tag=tag, args=args(out, mesh, save=save, variant=variant), frozen=True,
                     compare=True, projector=one[variant]["file"],
                     save_batch=None if variant else os.path.join(root, f"batch_{tag}.pt"))]
        if save:
            runs.append(dict(tag=tag + " resumed", args=args(
                out + "_resumed", mesh, resume=os.path.join(out, "step_2", "state"))))
        return runs

    def tiny_runs(mesh, variant, tag):
        out = os.path.join(root, f"tiny_{tag}")
        return [dict(tag=tag + " tiny", args=tiny_args(out, mesh, variant=variant)),
                dict(tag=tag + " tiny resumed", args=tiny_args(
                    out + "_resumed", mesh, os.path.join(out, "step_2", "state"), variant))]

    # the one-process runs: 4e's on the card (its projector after its 4
    # steps, in the port's names); each other variant's and the tiny
    # model's in this process beside the launches (a variant's writes the
    # projector file its meshes' runs compare with, so it goes first)
    keymap = _projector_keymap("linear-silu")
    export = torch.load(fp32["export"], weights_only=True)
    one = {"": dict(losses=fp32["losses"], evals=fp32["evals"], moments=fp32["moments"],
                    projector={ours: export[f"encoder_projector.{ref}"]
                               for ours, ref in keymap.items()},
                    file=os.path.join(root, "one_projector.pt"))}
    torch.save({"projector": one[""]["projector"], "moments": one[""]["moments"]},
               one[""]["file"])
    single = []
    for variant in PARALLEL_VARIANTS:
        if variant:
            one[variant] = dict(file=os.path.join(root, f"one_projector{variant}.pt"))
            single.insert(0, dict(tag=f"one {variant}", save_projector=one[variant]["file"],
                                  args=args(os.path.join(root, f"one_{variant}"),
                                            variant=variant)))
        single.append(dict(tag=f"tiny one {variant}", args=tiny_args(
            os.path.join(root, f"tiny_one{variant}"), variant=variant)))
    runs, meshes = [], {}
    for procs, entries in PARALLEL_GROUPS:
        for kind, mesh, variant in entries:
            tag = _mesh_tag(mesh) + (f"+{variant}" if variant else "")
            runs += [dict(r, procs=procs) for r in
                     (full_runs if kind == "full" else tiny_runs)(mesh, variant, tag)]
            meshes.setdefault(tag, dict(n=len(procs), mesh=mesh, variant=variant, full=False))
            meshes[tag]["full"] |= kind == "full"
    t1 = time.time()
    result: dict = {}

    def launched():
        try:
            result["done"] = launch_ranks(torch, PARALLEL_PROCESSES, runs, root,
                                          PARALLEL_TIMEOUT, "13a")
        finally:
            result["wall"] = round(time.time() - t1, 1)

    ranks = threading.Thread(target=launched)
    ranks.start()
    try:
        ones, one_walls = run13(torch, single)
    finally:
        ranks.join()
    t_one = round(time.time() - t1, 1)
    if "done" not in result:
        fail(f"{what}: the launch failed")
    ranks_of = result["done"].__getitem__

    rec = {r["tag"]: r for r in ones}
    batches, report, tiny = {}, {}, {}
    for variant in PARALLEL_VARIANTS:
        if variant:
            one[variant].update(losses=rec[f"one {variant}"]["losses"],
                                evals=rec[f"one {variant}"]["evals"])
        out = os.path.join(root, f"tiny_one{variant}")
        tiny[variant] = dict(losses=rec[f"tiny one {variant}"]["losses"], bytes=state_bytes(
            torch, os.path.join(out, "step_2", "state", "train_state.pt")))
    for tag, m in meshes.items():
        n, mesh, variant, full = m["n"], m["mesh"], m["variant"], m["full"]
        files = [f"train_state.rank{r}.pt" for r in range(n)]
        t_straight, t_res = ranks_of(tag + " tiny"), ranks_of(tag + " tiny resumed")
        t_state = os.path.join(root, f"tiny_{tag}", "step_2", "state")
        t_files = sorted(os.listdir(t_state))
        t_bytes = sum(state_bytes(torch, os.path.join(t_state, f)) for f in t_files)
        t_one = tiny[variant]
        t_loss = max(abs(a - b) for a, b in zip(t_straight[0]["losses"], t_one["losses"]))
        t_same = (all(r["losses"] == t_straight[0]["losses"] for r in t_straight)
                  and all(r["losses"] == t_straight[0]["losses"][2:] for r in t_res))
        ok = (t_same and t_files == files and t_bytes == t_one["bytes"]
              and len(t_straight[0]["losses"]) == len(t_one["losses"])
              and t_loss <= PARALLEL_TOL)
        tiny_line = (f"tiny model: losses {t_loss:.3e} off one process, resumed from step_2 "
                     f"{'bit-identical' if t_same else 'DIFFERENT'}, train state {t_files} "
                     f"{t_bytes} bytes of tensors (one process: {t_one['bytes']}); "
                     f"parameter bytes a rank {[r['bytes'] for r in t_straight]} of "
                     f"{t_straight[0]['full_bytes']}")
        if not full:
            print(f"{what} {tag} ({n} processes on one card, gloo): {tiny_line} [{CARD}]",
                  flush=True)
            if not ok:
                fail(f"{what} {tag}: the tiny model's ranks or resume differ, its train "
                     f"state holds a tensor twice or it is off the one-process run")
            continue
        straight = ranks_of(tag)
        same = all(r["losses"] == straight[0]["losses"] and r["evals"] == straight[0]["evals"]
                   for r in straight)
        got, want = straight[0], one[variant]
        if len(got["losses"]) != 4 or len(got["evals"]) != 2:
            fail(f"{what} {tag}: {len(got['losses'])} steps, {len(got['evals'])} evaluations")
        loss_err = max(abs(a - b) for a, b in zip(got["losses"] + got["evals"],
                                                  want["losses"] + want["evals"]))
        proj, mom_err = got["proj"], got["moment_err"]
        frozen = all(r["frozen_same"] for r in straight)
        resumed = ""
        ok = ok and same and frozen
        if mesh == PARALLEL_RESUME and not variant:
            res = ranks_of(tag + " resumed")
            res_same = all(r["losses"] == got["losses"][2:] for r in res)
            out = os.path.join(root, tag)
            export = torch.load(os.path.join(out, "step_4", "pytorch_model.bin"),
                                weights_only=True)
            exp = projector_errs({ours: export[f"encoder_projector.{ref}"]
                                  for ours, ref in keymap.items()}, want["projector"],
                                 want["moments"])
            states = sorted(os.listdir(os.path.join(out, "step_2", "state")))
            resumed = (f"; resumed from step_2: {res[0]['losses']} "
                       f"{'bit-identical' if res_same else 'DIFFERENT'}, train state "
                       f"{states}, rank 0's step_4 export off the one-process projector "
                       f"{exp['kept']:.3e} / {exp['floored']:.3e}")
            ok = (ok and res_same and exp["kept"] <= PARALLEL_TOL
                  and exp["floored"] <= PARALLEL_PROJ_TOL and states == files)
        report[tag] = dict(loss_err=loss_err, proj_err=proj["kept"],
                           proj_floored=proj["floored"], moment_err=mom_err,
                           bytes=got["bytes"])
        print(f"{what} {tag} ({n} processes on one card, gloo): losses {got['losses']}, "
              f"evals {got['evals']}; every rank's the same bit for bit {same}; against "
              f"one process: losses and evals {loss_err:.3e} (tol {PARALLEL_TOL}), AdamW's "
              f"first moments after micro-step {MOMENT_STEP} {mom_err:.3e} of each tensor's "
              f"largest (tol {PARALLEL_MOMENT_TOL}), trained projector {proj['kept']:.3e} "
              f"(tol {PARALLEL_TOL}) where its moment is at least {GRAD_FLOOR} of the "
              f"tensor's largest, {proj['floored']:.3e} on the {proj['n_floored']} elements "
              f"below (tol {PARALLEL_PROJ_TOL}); frozen weights bit-identical "
              f"{frozen}{'' if frozen else [r['frozen_changed'] for r in straight]}"
              f"{resumed}; {tiny_line}; micro-step ms rank 0 "
              f"{[round(x, 1) for x in got['ms']]}, gradient sums "
              f"{[round(x, 2) for x in got['sync_ms']]} ms; parameter bytes a rank "
              f"{[r['bytes'] for r in straight]} of {got['full_bytes']}; peak "
              f"{[round(r['peak'], 2) for r in straight]} GB [{CARD}]", flush=True)
        if (not ok or loss_err > PARALLEL_TOL or mom_err > PARALLEL_MOMENT_TOL
                or proj["kept"] > PARALLEL_TOL or proj["floored"] > PARALLEL_PROJ_TOL):
            fail(f"{what} {tag}: ranks differ, a frozen weight changed, a resume differs, "
                 f"a train state holds a tensor twice or the run is off the one-process "
                 f"run beyond its tolerance")
        if not variant:
            batches[tag] = torch.load(os.path.join(root, f"batch_{tag}.pt"), weights_only=True)
    print(f"{what}: meshes {list(meshes)} in {time.time() - t1:.1f} s (one launch of "
          f"{PARALLEL_PROCESSES} processes, done after {result['wall']} s; the one-process runs "
          f"in this process {dict(zip((r['tag'] for r in single), one_walls))} s, done after "
          f"{t_one} s)", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return {"model": fp32["model"], "batches": batches, "report": report}


def parallel_cases(torch, dev, model, batches: dict) -> dict:
    """Phase 3's cases at 13a's shards and microbatches, from each mesh's
    rank-0 batch through the one-process model (:func:`finetune_cases`):
    ``tensor`` divides the LLM's heads (6/1) and the encoder's (2/2, its
    forward: 4e's encoder is frozen), ``pipe`` cuts the rows into its
    microbatches (the LLM's attention and RMSNorm at one microbatch's
    rows), ``data`` / ``fsdp`` keep the rank's own rows."""
    from ps_slm_tpu_torch.parallel.pipeline import microbatch_count

    cases = {"flash": [], "norm": [], "flash_bwd": [], "norm_bwd": []}
    for tag, batch in batches.items():
        batch = {k: v.to(dev) for k, v in batch.items()}
        c = finetune_cases(torch, dev, model, batch, f"13a {tag}")
        mesh = dict((k[:-1], int(k[-1])) for k in tag.split("+"))
        t = mesh.get("tensor", 1)
        llm = [x for x in c["flash"] if x[0].endswith("llm")]
        enc = [(x[0], x[1], x[2], x[3] // t, x[4] // t, *x[5:]) for x in c["flash"]
               if x[0].endswith("encoder") and t > 1]
        llm = [(x[0], x[1], x[2], x[3] // t, x[4] // t, *x[5:]) for x in llm]
        rms = [x for x in c["norm"] if x[0] == "rms_norm_fwd"] if t == 1 else []
        if "pipe" in mesh:
            rows = llm[0][1]
            mb = rows // microbatch_count(rows, 0, mesh["pipe"])
            llm = [(x[0] + f" microbatch {mb}", mb, x[2], x[3], x[4], x[5], x[6][:mb], x[7][:mb])
                   for x in llm]
            rms = [(w, mb * llm[0][2], d, k) for w, n, d, k in c["norm"] if w == "rms_norm_fwd"]
        seen = {x[1:5] for x in cases["flash"]}
        llm = [x for x in llm if x[1:5] not in seen]       # a shape once
        enc = [x for x in enc if x[1:5] not in seen]
        rms = [x for x in rms if x not in cases["norm"]]
        cases["flash"] += enc + llm
        cases["flash_bwd"] += llm
        cases["norm"] += rms
        cases["norm_bwd"] += [("rms_norm_bwd", n, d, k) for _, n, d, k in rms]
    return cases


def phase_parallel(torch, dev, chain: dict) -> dict:
    """Phase 13b: phase 7b's recipe (bf16, SenseVoiceSmall + linear-silu +
    Qwen2.5-1.5B) on phase 7's assets and 7a's export, in 2 processes
    sharing the card over gloo, on each mesh of PARALLEL_MESHES_BF16 (in
    one launch of 4 processes, two meshes at once), for a
    step or two (its train manifest, no validation): each rank's launches a
    micro-step exactly 7b's, by route; the micro-step wall, the gradient
    sums' time, each rank's peak memory and parameter bytes against the
    whole model's.  Two processes share one card: no scaling number.
    Returns each mesh's rank-0 launches a micro-step, the launches of every
    rank's micro-steps and phase 3's cases at a rank's largest batch."""
    root = os.path.join(chain["root"], "parallel")
    runs = []
    for mesh, utts, procs in PARALLEL_MESHES_BF16:
        tag = _mesh_tag(mesh)
        data = os.path.join(root, f"data_{tag}")
        for split, seed in (("train", 3), ("dev", 4)):
            write_manifest(os.path.join(data, split), utts, DECODE_SECONDS, seed=seed)
        args = [a if not a.startswith("ckpt_path=") else f"ckpt_path={chain['init']}"
                for a in finetune_args(chain["assets"], data, os.path.join(root, tag),
                                       **chain["dims"])]
        # the per-rank shapes (phase 3's rows) from a run whose model is whole
        # (a sharded model's forward runs its collectives: data's alone is whole)
        runs.append(dict(tag=tag, check=True, cases=set(mesh) == {"data"}, procs=procs, args=args + [
            "++train_config.num_epochs=1", "++train_config.run_validation=false",
            "++train_config.save_model=false", "++train_config.mesh_shape=" + json.dumps(mesh)]))
    t0 = time.time()
    torch.cuda.empty_cache()          # the ranks need the card's memory, not this process's cache
    done = launch_ranks(torch, 1 + max(p for *_, procs in PARALLEL_MESHES_BF16 for p in procs),
                        runs, root, PARALLEL_TIMEOUT, "13b")
    out: dict = {"per_step": {}, "total": {}, "cases": None}
    for mesh, *_ in PARALLEL_MESHES_BF16:
        tag = _mesh_tag(mesh)
        recs = done[tag]
        bad = {r_i: rec["launch_mismatch"] for r_i, rec in enumerate(recs) if rec["launch_mismatch"]}
        same = all(rec["losses"] == recs[0]["losses"] for rec in recs)
        finite = all(math.isfinite(x) for x in recs[0]["losses"])
        import statistics

        ms = [statistics.median(rec["ms"]) for rec in recs]
        sync = [statistics.median(rec["sync_ms"]) for rec in recs]
        print(f"parallel bf16 {tag} (phase 7b's recipe, 2 processes sharing the card over gloo, "
              f"{len(recs[0]['losses'])} micro-steps): losses {[round(x, 4) for x in recs[0]['losses']]} "
              f"the same on both ranks {same}; micro-step wall median by rank "
              f"{[round(x, 1) for x in ms]} ms (phase 7b, one process: "
              f"{chain['median_ms']:.1f} ms); gradient sums (the trainable "
              f"projector's fp32 gradients over gloo) median {[round(x, 2) for x in sync]} ms a "
              f"micro-step; peak {[round(rec['peak'], 2) for rec in recs]} GB a rank; parameter "
              f"bytes a rank {[rec['bytes'] for rec in recs]} of the whole model's "
              f"{recs[0]['full_bytes']}; launches a micro-step 7b's on every rank "
              f"{not bad} [{CARD}]", flush=True)
        if bad or not same or not finite:
            fail(f"parallel bf16 {tag}: launches off 7b's {bad}, ranks differ or a loss is "
                 f"not finite")
        out["per_step"][tag] = recs[0]["launches"][0]
        for rec in recs:
            for launches in rec["launches"]:
                for k, v in launches.items():
                    out["total"][k] = out["total"].get(k, 0) + v
        out["cases"] = out["cases"] or recs[0].get("cases")
    print(f"parallel bf16: {time.time() - t0:.1f} s", flush=True)
    return out


def goldens_fp32_ref() -> str:
    """Phase 13c's CPU side: a temporary directory holding a SenseVoiceSmall
    and an LLM directory written from the seeded fp32 model (the encoder at
    2+1 blocks, the LLM at 1 layer, full widths) and ``goldens.npz``, their
    outputs on fixed inputs by the port's own modules on the CPU; the
    caller deletes it."""
    import numpy as np
    import torch

    from ps_slm_tpu_torch.config import half_audio_configs
    from ps_slm_tpu_torch.models.tasu import model_factory
    from ps_slm_tpu_torch.tools import goldens

    root = tempfile.mkdtemp(prefix="goldens_")
    tc, mc = half_audio_configs(*FP32_DEPTH, seed=0)
    src = model_factory(tc, mc, device="cpu")
    write_encoder_dir(os.path.join(root, "SenseVoiceSmall"), src.encoder)
    write_llm_dir(os.path.join(root, "llm"), src.llm, torch.float32)
    feats, lens = goldens._fixture()
    with torch.no_grad():
        hid, _ = src.encoder(torch.from_numpy(feats), torch.from_numpy(lens))
        ids = torch.from_numpy(np.random.default_rng(1).integers(0, 151000, size=(2, 16)))
        pos = torch.arange(16)[None].expand(2, -1)
        lh, _ = src.llm(src.llm.embed(ids), torch.ones(2, 16, dtype=torch.bool), pos)
        np.savez(os.path.join(root, "goldens.npz"), enc_hidden=hid.numpy(),
                 ctc_logits=src.encoder.ctc_logits(hid).numpy(), llm_ids=ids.numpy(),
                 llm_logits=src.llm.unembed(lh).numpy())
    return root


def phase_parallel_tools(torch, dev, ref) -> None:
    """Phase 13c: ``whisper_log_mel`` on the card against the CPU on two
    30 s windows (WHISPER_TOL after the (x + 4) / 4 scaling), then
    ``tools/goldens.py``'s ``verify`` on the card against goldens written
    by the port's own modules on the CPU (``ref``: :func:`goldens_fp32_ref`
    in the reference worker): PASS, then FAIL once an encoder weight is
    corrupted."""
    import numpy as np

    from ps_slm_tpu_torch.ops.fbank import pad_or_trim, whisper_log_mel
    from ps_slm_tpu_torch.tools import goldens

    rng = np.random.default_rng(0)
    wav = torch.stack([pad_or_trim(torch.from_numpy(
        (0.1 * rng.normal(size=16000 * s)).astype(np.float32))) for s in (7, 30)])
    want = whisper_log_mel(wav)
    got = whisper_log_mel(wav.to(dev))
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        whisper_log_mel(wav.to(dev))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) / 3 * 1e3
    err = float((got.cpu() - want).abs().max())
    print(f"whisper_log_mel [2, 128, 3000] card vs CPU: max err {err:.3e} (tol {WHISPER_TOL}); "
          f"{ms:.2f} ms a call on the card (host clock, the copy in) [{CARD}]", flush=True)
    if got.shape != (2, 128, 3000) or err > WHISPER_TOL:
        fail(f"whisper_log_mel: card vs CPU {err}")

    root = ref.result()
    try:
        enc_dir, llm_dir = os.path.join(root, "SenseVoiceSmall"), os.path.join(root, "llm")
        npz = os.path.join(root, "goldens.npz")
        lines: list = []
        ok = goldens.verify(npz, encoder_dir=enc_dir, llm_dir=llm_dir, device=dev,
                            log=lines.append)
        state = torch.load(os.path.join(enc_dir, "model.pt"), weights_only=True)
        key = next(k for k in state if k.endswith("feed_forward.w_1.weight"))
        state[key] = state[key] + 0.05 * torch.randn(
            state[key].shape, generator=torch.Generator().manual_seed(0))
        torch.save(state, os.path.join(enc_dir, "model.pt"))
        bad_lines: list = []
        bad = goldens.verify(npz, encoder_dir=enc_dir, device=dev, log=bad_lines.append)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"goldens verify on the card against the port's CPU goldens: {'; '.join(lines)}; "
          f"after corrupting {key}: {'; '.join(bad_lines)} [{CARD}]", flush=True)
    if ok != 0 or bad != 1:
        fail("goldens verify: not PASS on the port's goldens, or not FAIL on a corrupted weight")


def phase_kernels_parallel(torch, dev, results, par: dict, tag: str) -> dict:
    """Phase 3 at 13a's shard and microbatch shapes (``par`` holds 13a's
    one-process model and ranks' batches) or at 13b's per-rank batch
    (``par["cases"]``); returns the cases, labelled ``tag``."""
    cases = par.get("cases") or parallel_cases(torch, dev, par["model"], par["batches"])
    phase_kernels(torch, dev, results, cases["flash"], cases["norm"], tag)
    phase_kernels_bwd(torch, dev, results, cases["flash_bwd"], cases["norm_bwd"], tag)
    return cases


def add_case_rows(path_rows: dict, cases: dict, tag: str) -> None:
    """The labels phase 3 gave ``cases`` (run with ``tag``), by the kernels
    line's names."""
    for name in ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv"):
        path_rows.setdefault(name, []).extend(
            c[0] for c in cases["flash" if name.endswith("fwd") else "flash_bwd"])
    for w, n, d, kind in cases["norm"] + cases["norm_bwd"]:
        label = f"{tag} {n}x{d}" + (f" {kind}" if kind else "")
        name = {"layer_norm_fwd": f"{w} ({'staged' if d == 25055 else 'vec'})",
                "layer_norm_bwd": f"{w} ({'wide' if d == 25055 else 'vec'})"}.get(w, w)
        path_rows.setdefault(name, []).append(label)
        if w.endswith("_bwd"):
            path_rows[name].append(f"{label} frozen w")


def start_refs() -> None:
    """Start REFS: one worker process (spawned, so the card's context is not
    forked; the card hidden from it) with every core but two, which
    computes the fp32 phases' CPU references beside the card's work; each
    phase collects its result where it compares it."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    global REFS
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""      # the references see no card
    try:
        REFS = ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn"),
                                   initializer=_refs_init,
                                   initargs=(max(1, (os.cpu_count() or 3) - 2),))
        REFS.submit(os.getpid).result()          # the worker starts now, in that environment
    finally:
        if visible is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = visible


def _refs_init(threads: int) -> None:
    import torch

    torch.set_num_threads(threads)
    os.nice(10)     # the card's work, 13a's ranks included, comes first


def run_slice13(torch, dev) -> None:
    """``--slice13``: phase 13 alone (4e, whose run 13a takes as the
    one-process run, 13a, 13c, and 13b on phase 7's assets with their
    projector checkpoint as the initial one) and phase 3 at its shapes."""
    results: dict = {}
    ref_4e = REFS.submit(finetune_cli_fp32_run, "cpu")
    ref_13c = REFS.submit(goldens_fp32_ref)
    fp32 = timed("4e finetune CLI fp32", phase_finetune_cli_fp32, torch, dev, ref_4e)
    par = timed("13a parallel fp32", phase_parallel_fp32, torch, dev, fp32)
    timed("4e against the CPU", fp32["against_cpu"])
    del fp32
    timed("3 at 13a's shapes", phase_kernels_parallel, torch, dev, results, par, "13a")
    del par
    torch.cuda.empty_cache()
    timed("13c whisper and goldens", phase_parallel_tools, torch, dev, ref_13c)
    root = tempfile.mkdtemp(prefix="slice13_")
    try:
        assets, _, mc = write_chain_assets(torch, root)
        chain = {"assets": assets, "root": root, "init": assets["ckpt_path"],
                 "dims": dict(llm_dim=mc.llm_dim, encoder_dim=mc.encoder_dim),
                 "median_ms": float("nan")}
        par_b = timed("13b parallel bf16", phase_parallel, torch, dev, chain)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    timed("3 at 13b's shapes", phase_kernels_parallel, torch, dev, results, par_b, "13b")


def timed(label: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall seconds printed and kept in
    PHASE_SECONDS under ``label``."""
    t = time.time()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_SECONDS[label] = round(time.time() - t, 1)
        print(f"phase {label}: {PHASE_SECONDS[label]:.1f} s", flush=True)


def phase_kernels_slice12(torch, dev, results, enc_cases: dict) -> None:
    """Phase 3 at 12b's encoder step (flash non-causal 4/4 heads with the
    ragged rows, the LayerNorms at 560 / 512 with dw/db) and at the
    q-former's LayerNorms (768 at eps 1e-12, 1536 at 1e-5)."""
    phase_kernels(torch, dev, results, enc_cases["flash"], enc_cases["norm"], "encoder train")
    phase_kernels_bwd(torch, dev, results, enc_cases["flash"], enc_cases["norm_bwd"],
                      "encoder train")
    phase_kernels(torch, dev, results, (), QF_NORM_CASES, "q-former")
    phase_kernels_bwd(torch, dev, results, (), QF_NORM_BWD_CASES, "q-former")


def run_slice12(torch, dev) -> None:
    """``--slice12``: phase 12 alone (12a, 12d on a phase 5 model, 12b, 12c,
    the q-former CLI on phase 7's assets) and phase 3 at its shapes."""
    from ps_slm_tpu_torch.config import half_audio_configs
    from ps_slm_tpu_torch.models.tasu import model_factory

    results: dict = {}
    ref_enc = REFS.submit(encoder_fp32_run, "cpu")
    ref_proj = REFS.submit(projectors_fp32_run, "cpu")
    timed("12a encoder fp32", phase_encoder_fp32, torch, dev, ref_enc)
    timed("12a projectors fp32", phase_projectors_fp32, torch, dev, ref_proj)
    tc, mc = half_audio_configs()
    model = model_factory(tc, mc, dtype=torch.bfloat16)
    model.speech_token_id = SPEECH_TOKEN
    timed("12d projectors", phase_projectors, torch, dev, model, {})
    del model
    torch.cuda.empty_cache()
    enc_cases = timed("12b encoder training", phase_encoder_train, torch, dev, {})
    timed("12c standalone ASR", phase_asr, torch, dev, {})
    root = tempfile.mkdtemp(prefix="slice12_")
    try:
        assets, _, _ = write_chain_assets(torch, root)
        timed("12d q-former CLI", phase_qformer_cli, torch, dev, assets, root, {}, 4)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    timed("3 at 12's shapes", phase_kernels_slice12, torch, dev, results, enc_cases)


def run_decode_and_serving(torch, dev, results, cli_launches, serve_launches,
                           serve_cli_launches, refs: dict) -> tuple:
    """Phase 6, phase 3 at its largest batch, then phase 8 on phase 6's
    assets (8b, 8c; 8a after the assets are deleted), phase 10 (10b on the
    same assets, 10a after 8a) and phase 3 at the pools' shapes.  Returns
    phase 6's launches per batch and cases, 8c's pool columns and 10b's
    launches by run."""
    root = tempfile.mkdtemp(prefix="serving_")
    try:
        cli_per_batch, cli_flash, cli_norm, assets = timed(
            "6 decode CLI", phase_decode_cli, torch, dev, cli_launches, root)
        timed("3 at 6's shapes", phase_kernels, torch, dev, results, cli_flash, cli_norm)
        model = timed("8b serving", phase_serving, torch, dev, serve_launches, assets)
        pools = timed("8c serving pools", phase_serving_pools, torch, dev, serve_launches,
                      model, assets)
        del model
        torch.cuda.empty_cache()
        serve_runs = timed("10b serve CLI", phase_serve_cli, torch, dev, serve_cli_launches,
                           assets)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    timed("8a serving fp32", phase_serving_fp32, torch, dev, refs["8a"])
    timed("3 at 8c's shapes", phase_kernels, torch, dev, results, pools["flash"],
          pools["norm"], "serving pool")
    timed("10a serve CLI fp32", phase_serve_cli_fp32, torch, dev, refs["10a"])
    return cli_per_batch, cli_flash, cli_norm, pools, serve_runs


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(HERE, "ps_slm_tpu_torch", "csrc")):
        fail("the ps_slm_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    from ps_slm_tpu_torch import _build

    t_start = time.time()
    start_refs()
    dev = torch.device("cuda", 0)
    try:
        card = card_line()
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        fail(f"nvidia-smi: {e}")
    print(f"card: {card}", flush=True)
    global CARD
    CARD = card
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    try:
        logs = _build.build_all()
    except RuntimeError as e:
        fail(f"build: {e}")
    PHASE_SECONDS["1-2 build"] = round(time.time() - t0, 1)
    print(f"build: {time.time() - t0:.1f} s ({', '.join(_build.SOURCES)})", flush=True)
    phase_paths(logs)
    if "--variants" in sys.argv[1:]:
        phase_ln_variants(torch, dev)
        phase_ln_bwd_variants(torch, dev)
        print(f"variants done, {time.time() - t_start:.1f} s", flush=True)
        return
    if "--slice12" in sys.argv[1:]:
        run_slice12(torch, dev)
        print(f"phase seconds: {json.dumps(PHASE_SECONDS)}", flush=True)
        print(f"slice 12 done, {time.time() - t_start:.1f} s", flush=True)
        return
    if "--slice13" in sys.argv[1:]:
        run_slice13(torch, dev)
        print(f"phase seconds: {json.dumps(PHASE_SECONDS)}", flush=True)
        print(f"slice 13 done, {time.time() - t_start:.1f} s", flush=True)
        return

    print("kernel vs plain tolerance, |a - b| <= atol + rtol * |b|: "
          + ", ".join(f"{dt} atol {a} rtol {r}" for dt, (a, r) in KERNEL_TOL.items()),
          flush=True)
    # the fp32 phases' CPU references: 4-4e's now (awaited after 13a, beside
    # whose ranks they may still run), the rest once 13a (whose ranks take
    # every core) is done
    refs = {key: REFS.submit(fn, *args) for key, fn, args in (
        ("4", path_fp32_run, ("cpu",)), ("4b", train_fp32_run, ("cpu",)),
        ("4c", beam_text_only_fp32_run, ("cpu",)), ("4d", decode_cli_fp32_run, ("cpu",)),
        ("4e", finetune_cli_fp32_run, ("cpu",)))}
    results: dict = {}
    timed("3 kernels", phase_kernels, torch, dev, results)
    timed("3 kernels backward", phase_kernels_bwd, torch, dev, results)
    # 13a needs 4e's card run only; 4-4d's card sides come after it, when
    # their CPU runs (computed beside phase 3 and 13a) are done
    fp32 = timed("4e finetune CLI fp32", phase_finetune_cli_fp32, torch, dev, refs["4e"])
    par = timed("13a parallel fp32", phase_parallel_fp32, torch, dev, fp32)
    refs.update({key: REFS.submit(fn, *args) for key, fn, args in (
        ("13c", goldens_fp32_ref, ()), ("11a", peft_fp32_runs, ("cpu",)),
        ("12a encoder", encoder_fp32_run, ("cpu",)),
        ("12a projectors", projectors_fp32_run, ("cpu",)), ("8a", serving_fp32_run, ("cpu",)),
        ("10a", serve_cli_fp32_run, ("cpu",)))})
    timed("4 serving path fp32", phase_path_fp32, torch, dev, refs["4"])
    timed("4b train fp32", phase_train_fp32, torch, dev, refs["4b"])
    timed("4c beam and text-only fp32", phase_beam_text_only_fp32, torch, dev, refs["4c"])
    timed("4d decode CLI fp32", phase_decode_cli_fp32, torch, dev, refs["4d"])
    timed("4e against the CPU", fp32["against_cpu"])
    del fp32
    cases13 = {"13a": timed("3 at 13a's shapes", phase_kernels_parallel, torch, dev, results,
                            par, "13a")}
    del par
    torch.cuda.empty_cache()
    gen_launches: dict = {}
    model = timed("5 main path", phase_main, torch, dev, gen_launches)
    train_launches: dict = {}
    step_5b_prof = timed("5b train", phase_train_main, torch, dev, model, train_launches)
    beam_launches: dict = {}
    timed("5c beam", phase_main, torch, dev, beam_launches, model, beam=True)
    text_launches: dict = {}
    timed("5d text-only train", phase_train_main, torch, dev, model, text_launches,
          text_only=True)
    proj_launches: dict = {}
    proj_per_step = timed("12d projectors", phase_projectors, torch, dev, model, proj_launches)
    del model
    torch.cuda.empty_cache()
    enc_launches, asr_launches = {}, {}
    enc_cases = timed("12b encoder training", phase_encoder_train, torch, dev, enc_launches)
    timed("12c standalone ASR", phase_asr, torch, dev, asr_launches)
    timed("13c whisper and goldens", phase_parallel_tools, torch, dev, refs["13c"])
    timed("11a PEFT fp32", phase_peft_fp32, torch, dev, refs["11a"])
    timed("12a encoder fp32", phase_encoder_fp32, torch, dev, refs["12a encoder"])
    timed("12a projectors fp32", phase_projectors_fp32, torch, dev, refs["12a projectors"])
    cli_launches, serve_launches, serve_cli_launches = {}, {}, {}
    cli_per_batch, cli_flash, cli_norm, pools, serve_runs = run_decode_and_serving(
        torch, dev, results, cli_launches, serve_launches, serve_cli_launches, refs)
    chain_launches, peft_launches = {}, {}
    chain_root = tempfile.mkdtemp(prefix="finetune_chain_")
    try:
        chain_per_step = timed("7 finetune chain", phase_finetune_chain, torch, dev,
                               chain_launches, step_5b_prof, chain_root)
        par_b = timed("13b parallel bf16", phase_parallel, torch, dev, chain_per_step)
        peft_per_step = timed("11b-c PEFT", phase_peft, torch, dev, peft_launches,
                              chain_per_step)
        qf_launches: dict = {}
        timed("12d q-former CLI", phase_qformer_cli, torch, dev, chain_per_step["assets"],
              chain_root, qf_launches, chain_per_step["steps"] // 2 + 1)
    finally:
        shutil.rmtree(chain_root, ignore_errors=True)
    t3 = time.time()
    for stage, cases in chain_per_step["cases"].items():
        phase_kernels(torch, dev, results, cases["flash"], cases["norm"], f"finetune {stage}")
        phase_kernels_bwd(torch, dev, results, cases["flash_bwd"], cases["norm_bwd"],
                          f"finetune {stage}")
    PHASE_SECONDS["3 at 7's shapes"] = round(time.time() - t3, 1)
    timed("3 at 12's shapes", phase_kernels_slice12, torch, dev, results, enc_cases)
    cases13["13b"] = timed("3 at 13b's shapes", phase_kernels_parallel, torch, dev, results,
                           par_b, "13b")

    # (name, its launch count, the CUDA kernel it launches at the main
    # paths' bf16 shapes, source, TPU kernel it replaces, the rows of phase
    # 3 it covers; the first is reported)
    norms_cu = "ps_slm_tpu_torch/csrc/norms.cu"
    table = (
        ("flash_attention_fwd", "flash_attention_fwd", "flash_fwd_bf16_kernel",
         "ps_slm_tpu_torch/csrc/flash_fwd.cu", "ps_slm_tpu/ops/flash_attention.py:59",
         ("encoder", "llm_prefill", "text_only")),
        ("flash_attention_dq", "flash_attention_dq", "flash_dq_bf16_kernel",
         "ps_slm_tpu_torch/csrc/flash_bwd.cu", "ps_slm_tpu/ops/flash_attention.py:125",
         ("training", "ragged", "text_only")),
        ("flash_attention_dkv", "flash_attention_dkv", "flash_dkv_bf16_kernel + dkv_reduce_kernel",
         "ps_slm_tpu_torch/csrc/flash_bwd.cu", "ps_slm_tpu/ops/flash_attention.py:181",
         ("training", "ragged", "text_only")),
        ("layer_norm_fwd (vec)", "layer_norm_fwd.vec", "norm_fwd_vec_kernel<T, chunks, LayerNorm>",
         norms_cu, "ps_slm_tpu/ops/norms.py:49", ("2064x512", "2064x560")),
        ("layer_norm_fwd (staged)", "layer_norm_fwd.staged", "layer_norm_fwd_staged_kernel<T>",
         norms_cu, "ps_slm_tpu/ops/norms.py:49", ("2064x25055", "640x25055 mixed", "640x25055 clean")),
        ("layer_norm_bwd (vec)", "layer_norm_bwd.vec",
         "layer_norm_bwd_vec_kernel<T, chunks, dw/db> + partial_sum_kernel",
         "ps_slm_tpu_torch/csrc/ln_bwd.cu",
         "ps_slm_tpu/ops/norms.py:73", ("760x560", "760x512", "760x560 frozen w",
                                        "760x512 frozen w")),
        ("layer_norm_bwd (wide)", "layer_norm_bwd.wide", "layer_norm_bwd_kernel + partial_sum_kernel",
         norms_cu, "ps_slm_tpu/ops/norms.py:73", ("2560x25055", "640x25055 mixed",
                                                  "2560x25055 frozen w", "640x25055 mixed frozen w")),
        ("rms_norm_fwd", "rms_norm_fwd", "norm_fwd_vec_kernel<T, chunks, RMSNorm>", norms_cu,
         "ps_slm_tpu/ops/norms.py:61", ("2172x1536", "4x1536", "16x1536", "795x1536")),
        ("rms_norm_bwd", "rms_norm_bwd", "rms_norm_bwd_vec_kernel<T, chunks, no dw>", norms_cu,
         "ps_slm_tpu/ops/norms.py:94", ("2715x1536 frozen w", "2715x1536", "795x1536 frozen w",
                                                    "795x1536")),
    )
    # phase 6's largest batch, as phase 3 labelled its rows
    path_rows: dict = {
        "flash_attention_fwd": [c[0] for c in cli_flash],
        "layer_norm_fwd (vec)": [f"{n}x{d}" for w, n, d, _ in cli_norm
                                 if w == "layer_norm_fwd" and d < 25055],
        "layer_norm_fwd (staged)": [f"{n}x{d}" for w, n, d, _ in cli_norm
                                    if w == "layer_norm_fwd" and d == 25055],
        "rms_norm_fwd": [f"{n}x{d}" for w, n, d, _ in cli_norm if w == "rms_norm_fwd"],
    }
    # phase 8c's pool shapes, as phase 3 labelled their rows
    path_rows["flash_attention_fwd"] += [c[0] for c in pools["flash"]]
    for w, n, d, kind in pools["norm"]:
        name = f"{w} ({'staged' if d == 25055 else 'vec'})" if w == "layer_norm_fwd" else w
        path_rows[name].append(f"serving pool {n}x{d}")
    # phase 12b's encoder step and the q-former's norms, as phase 3 labelled them
    for name in ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv"):
        path_rows[name] = path_rows.get(name, []) + [c[0] for c in enc_cases["flash"]]
    for tag, cases in (("encoder train", enc_cases["norm"] + enc_cases["norm_bwd"]),
                       ("q-former", QF_NORM_CASES + QF_NORM_BWD_CASES)):
        for w, n, d, _, *eps in cases:
            name = f"{w} (vec)"
            label = f"{tag} {n}x{d}" + (f" eps{eps[0]:g}" if eps and eps[0] != 1e-5 else "")
            path_rows.setdefault(name, []).append(label)
            if w == "layer_norm_bwd":
                path_rows[name].append(f"{label} frozen w")
    # phase 7's largest batches and phase 13's shards, as phase 3 labelled their rows
    for stage, cases in chain_per_step["cases"].items():
        add_case_rows(path_rows, cases, f"finetune {stage}")
    for tag, cases in cases13.items():
        add_case_rows(path_rows, cases, tag)
    kernels = []
    for name, count, kernel, source, replaces, shapes in table:
        shapes = shapes + tuple(path_rows.get(name, ()))
        rows = [r for r in results[name.split()[0]]["shapes"] if r["shape"] in shapes]
        row = next(r for r in rows if r["shape"] == shapes[0] and r["dtype"] == "bf16")
        kernels.append({
            "name": name, "kernel": kernel, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(runs.get(count, 0) for runs in (
                gen_launches, train_launches, beam_launches, text_launches, cli_launches,
                serve_launches, serve_cli_launches, peft_launches, proj_launches, enc_launches,
                asr_launches, qf_launches, par_b["total"]))
            + sum(runs[count] for runs in chain_launches.values()),
            "launches_per_generate": gen_launches[count],
            "launches_per_train_step": train_launches[count] // TRAIN_STEPS,
            "launches_per_beam_generate": beam_launches[count],
            "launches_per_text_only_step": text_launches[count] // TRAIN_STEPS,
            "launches_per_decode_cli_batch": cli_per_batch[count],
            "launches_per_finetune_step": chain_per_step["step"][count],
            "launches_per_finetune_step_remat": chain_per_step["remat"][count],
            "launches_per_validation_batch": chain_per_step["eval"][count],
            "launches_per_pool_chunk": {k: c[count] for k, c in pools["chunk"].items()},
            "launches_per_pool_refill": pools["refill"][count],
            "launches_per_serve_cli_run": {k: c[count] for k, c in serve_runs.items()},
            "launches_per_peft_step": peft_per_step[count],
            "launches_per_encoder_step": enc_launches.get(count, 0) // ENC_STEPS,
            "launches_per_asr_pass": asr_launches.get(count, 0) // 3,
            "launches_per_projector_step": {k: c.get(count, 0) for k, c in proj_per_step.items()},
            "launches_per_parallel_step": {k: c.get(count, 0)
                                           for k, c in par_b["per_step"].items()},
            "max_abs_err": max(r["err"] for r in rows),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": f"{shapes[0]} bf16",
        })
    REFS.shutdown()
    print(f"phase seconds: {json.dumps(PHASE_SECONDS)}", flush=True)
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank13"]:
        rank13_worker(sys.argv[2])
    else:
        main()
