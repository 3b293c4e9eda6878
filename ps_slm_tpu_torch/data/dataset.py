"""Multitask streaming dataset and deterministic token-budget batching.

A copy of ``ps_slm_tpu/data/dataset.py`` (the port imports nothing of the
JAX package); batches stay numpy on the host, and the caller moves them to
the device:

  * JSONL manifest {key, path, target, task, GT, <task extras>} streamed
    from ``<split dir>/multitask.jsonl``;
  * task prompts from ``conf/multiprompt.jsonl``, one drawn per sample from
    a seeded ``random.Random``; the ``prompt_style`` chat template with the
    ``<speech>`` marker; append-info tasks format their field in;
  * the 0.1-30 s audio filter; training targets normalized by
    ``[^A-Za-z\\s.,!?']+`` and lower-cased; labels = input_ids with the
    prompt masked to -100;
  * token-budget dynamic batching (close the bucket when
    ``(n + 1) * max cost > max_frame_length``) or fixed batches;
  * the collator pads right for training, left for inference, buckets every
    padded length, and ships waveforms as int16 (the front end runs on the
    device: ``ops/fbank.py``);
  * deterministic global batching: every host walks the same manifest,
    computes the same buckets and keeps its contiguous block of rows,
    padded with ``batch_valid`` False rows (``PS_NUM_HOSTS``/``PS_HOST_ID``
    in the decode CLI);
  * the GT text is tokenized with the encoder's BPE into ``gt_ids``.

The whisper front end (``DataConfig.encoder == "whisper"``) computes the
128-mel log spectrogram of each 30 s window on the host
(``ops/fbank.py::whisper_log_mel``) into ``input_features``.
"""

from __future__ import annotations

import json
import os
import random
import re
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ps_slm_tpu_torch.registry import register_dataset

TARGET_NORM_RE = re.compile(r"[^A-Za-z\s.,!?']+")
GT_NORM_RE = re.compile(r"[^A-Za-z\s.,!?]+")  # the generate path's


def load_multiprompt(path: str) -> Dict[str, List[str]]:
    """conf/multiprompt.jsonl -> {task: [prompts]}."""
    out: Dict[str, List[str]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            item = json.loads(line)
            out.setdefault(item["task"], []).append(item["prompt"])
    return out


@dataclass
class Sample:
    key: str
    input_ids: np.ndarray          # prompt (+target+eos at train)
    labels: Optional[np.ndarray]   # None at inference
    prompt_len: int
    waveform: Optional[np.ndarray]
    est_frames: int                # LFR frame estimate for budgeting
    gt_ids: np.ndarray
    target: str
    gt: str
    task: str
    waveform_len: int = 0          # exact sample count (known without
    #                                decoding under lazy_audio — lets the
    #                                collator compute global pad shapes)


class MultiTaskDataset:
    """Streaming manifest reader producing :class:`Sample`s."""

    def __init__(
        self,
        dataset_config,
        tokenizer,
        split: str = "train",
        encoder_tokenizer=None,
        *,
        load_audio: bool = True,
        lazy_audio: bool = False,
        seed: int = 42,
    ):
        self.cfg = dataset_config
        self.tokenizer = tokenizer
        self.encoder_tokenizer = encoder_tokenizer
        self.split = split
        self.inference_mode = split in ("test", "serve") or dataset_config.inference_mode
        self.load_audio = load_audio
        self.lazy_audio = lazy_audio
        self.seed = seed
        self.prompts = load_multiprompt(dataset_config.multitask_prompt_path)

        if split == "train":
            self.data_path = dataset_config.train_scp_file_path
        elif split in ("val", "dev"):
            self.data_path = dataset_config.dev_scp_file_path
        elif split == "test":
            self.data_path = dataset_config.test_scp_file_path
        elif split == "serve":
            self.data_path = None
        else:
            raise ValueError("split must be train/val/test/serve")
        self.manifest = (None if self.data_path is None
                         else os.path.join(self.data_path, "multitask.jsonl"))
        self.sample_rate = 16000
        self.max_samples = dataset_config.max_audio_length * self.sample_rate
        self.min_samples = int(0.1 * self.sample_rate)

    @classmethod
    def for_requests(cls, dataset_config, tokenizer, encoder_tokenizer=None):
        """A builder with no manifest, for serving: only :meth:`_build` is
        used, on request dicts (``cli/serve.py``)."""
        return cls(dataset_config, tokenizer, "serve", encoder_tokenizer, seed=0)

    def __len__(self) -> int:
        with open(self.manifest, "rb") as f:
            return sum(1 for _ in f)

    def _est_frames(self, num_samples: int) -> int:
        """LFR frames from raw samples (400/160 framing, /6 stacking)."""
        fbank_frames = max(1 + (num_samples - 400) // 160, 0)
        return -(-fbank_frames // 6)

    def __iter__(self) -> Iterator[Sample]:
        rng = random.Random(self.seed)
        with open(self.manifest) as f:
            for index, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                item = json.loads(line)
                sample = self._build(item, rng, index)
                if sample is not None:
                    yield sample

    def _build(self, item: dict, rng, index: int) -> Optional[Sample]:
        key = item["key"]
        path = item["path"]
        target = item.get("target", "")
        task = item.get("task", "ASR")

        raw_gt = item.get("GT", "")
        if not isinstance(raw_gt, str):
            # explicit JSON null / numeric GT: degrade like the reference's
            # blanket try/except did (GT only feeds the _gt scoring file)
            raw_gt = "" if raw_gt is None else str(raw_gt)
        # unicode_escape only on ASCII strings: escaped manifests (literal
        # \uXXXX) round-trip, and real UTF-8 GT ("你好", "café") stays intact
        if raw_gt.isascii():
            try:
                gt = raw_gt.encode("utf-8").decode("unicode_escape")
            except Exception:
                gt = raw_gt
        else:
            gt = raw_gt

        waveform = None
        est_frames = 0
        n = 0
        if self.load_audio:
            from ps_slm_tpu_torch.data import audio_io

            if self.lazy_audio:
                # resume fast-forward: header-only length (identical to
                # len(load_audio(...)) by construction) keeps filtering and
                # bucketing bit-equal while deferring the decode to the
                # collator — skipped batches never decode at all
                n = audio_io.audio_num_samples(path, self.sample_rate)
                waveform = (
                    lambda p=path, sr=self.sample_rate:
                    audio_io.load_audio(p, sr)
                )
            else:
                waveform = audio_io.load_audio(path, self.sample_rate)
                n = len(waveform)
            if n > self.max_samples or n < self.min_samples:
                return None  # the 0.1-30 s filter
            if self.cfg.encoder == "whisper":
                # the whisper front end is a fixed 30 s -> 3000 mel frames
                est_frames = 3000
            else:
                est_frames = self._est_frames(n)

        prompt = rng.choice(self.prompts[task])
        prompt = self.cfg.prompt_style.format(prompt)
        if task in self.cfg.append_info_tasks:
            prompt = prompt.format(item[task])
        prompt_ids = self.tokenizer.encode(prompt)

        if not self.inference_mode:
            norm_target = TARGET_NORM_RE.sub("", target).lower().strip()
            target_ids = self.tokenizer.encode(norm_target)
            target_ids = target_ids + [self.tokenizer.eos_token_id]
            input_ids = np.asarray(prompt_ids + target_ids, np.int32)
            labels = input_ids.copy()
            labels[: len(prompt_ids)] = self.tokenizer.default_ignore_token
        else:
            input_ids = np.asarray(prompt_ids, np.int32)
            labels = None

        if self.encoder_tokenizer is not None:
            if self.inference_mode:
                # the generate path uses the regex-normalized *target*
                gt_text = GT_NORM_RE.sub("", target).lower().strip()
            else:
                # the training path feeds the raw GT text
                gt_text = gt
            gt_ids = np.asarray(
                self.encoder_tokenizer.encode(gt_text), np.int32
            )
        else:
            gt_ids = np.zeros((0,), np.int32)

        return Sample(
            key=key, input_ids=input_ids, labels=labels,
            prompt_len=len(prompt_ids), waveform=waveform,
            est_frames=est_frames, gt_ids=gt_ids, target=target, gt=gt,
            task=task, waveform_len=n,
        )


# ----------------------------------------------------------------------------
# token-budget bucketing (window_class semantics) + collation
# ----------------------------------------------------------------------------

def _frame_cost(s: Sample, ds_rate: int) -> int:
    return len(s.input_ids) + (s.est_frames // ds_rate) - 1


def dynamic_batches(
    samples: Iterator[Sample], max_frame_length: int, ds_rate: int
) -> Iterator[List[Sample]]:
    """Close the bucket when (n+1) * max_cost would exceed the budget."""
    buf: List[Sample] = []
    cur_max = 0
    for s in samples:
        cost = _frame_cost(s, ds_rate)
        new_max = max(cur_max, cost)
        if buf and (len(buf) + 1) * new_max > max_frame_length:
            yield buf
            buf, cur_max = [s], cost
        else:
            buf.append(s)
            cur_max = new_max
    if buf:
        yield buf


def fixed_batches(
    samples: Iterator[Sample], batch_size: int
) -> Iterator[List[Sample]]:
    """batching_strategy="padding": a fixed batch size."""
    buf: List[Sample] = []
    for s in samples:
        buf.append(s)
        if len(buf) == batch_size:
            yield buf
            buf = []
    if buf:
        yield buf


def _bucket(n: int, mult: int) -> int:
    return max(((n + mult - 1) // mult) * mult, mult)


def _pad_to(arr: np.ndarray, length: int, value, left: bool = False):
    pad = length - len(arr)
    if pad <= 0:
        return arr[:length]
    widths = [(pad, 0)] if left else [(0, pad)]
    widths += [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, widths, constant_values=value)


class Collator:
    """Sample list -> padded numpy batch (right-pad train / left-pad
    inference), every padded length bucketed."""

    def __init__(self, tokenizer, cfg, inference_mode: bool = False):
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.inference_mode = inference_mode

    def shape_hints(self, samples: List[Sample]) -> Dict[str, Any]:
        """Padding targets from the FULL global bucket.

        Multi-host: GlobalBatcher hands each host only its slice of the
        bucket; pad shapes and batch keys computed from the slice alone
        could differ between hosts.  Computing them over the whole bucket
        keeps every host's batch identical in structure.  Uses
        ``waveform_len`` (not the array) so lazy_audio rows are never
        decoded."""
        tb = self.cfg.token_bucket
        hints: Dict[str, Any] = {
            "s_len": _bucket(max(len(s.input_ids) for s in samples), tb),
            "has_gt": any(len(s.gt_ids) for s in samples),
        }
        if hints["has_gt"]:
            hints["g_len"] = _bucket(
                max(len(s.gt_ids) for s in samples), tb
            )
        if samples[0].waveform is not None and self.cfg.encoder != "whisper":
            def wav_len(s):
                if s.waveform_len:
                    return s.waveform_len
                if s.waveform is not None and not callable(s.waveform):
                    return len(s.waveform)
                return 0

            wav_bucket = self.cfg.feature_bucket * 6 * 160
            hints["n_len"] = _bucket(
                max(wav_len(s) for s in samples), wav_bucket
            )
        return hints

    def __call__(
        self, samples: List[Sample],
        hints: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, np.ndarray]:
        if hints is None:
            hints = self.shape_hints(samples)
        for s in samples:
            if callable(s.waveform):  # lazy_audio: decode at collate time
                s.waveform = s.waveform()
        left = self.inference_mode
        pad_id = self.tokenizer.pad_token_id
        ignore = self.tokenizer.default_ignore_token
        tb = self.cfg.token_bucket

        s_len = hints["s_len"]
        input_ids = np.stack([
            _pad_to(s.input_ids, s_len, pad_id, left) for s in samples
        ])
        attn = np.stack([
            _pad_to(np.ones(len(s.input_ids), bool), s_len, False, left)
            for s in samples
        ])
        batch: Dict[str, Any] = {
            "input_ids": input_ids,
            "attention_mask": attn,
        }
        if not self.inference_mode:
            batch["labels"] = np.stack([
                _pad_to(s.labels, s_len, ignore, left) for s in samples
            ])

        if samples[0].waveform is not None:
            if self.cfg.encoder == "whisper":
                # whisper path: pad_or_trim to 30 s, 128-mel log spectrogram
                # on the host, fixed 3000 frames, time-major [B, 3000, 128]
                import torch

                from ps_slm_tpu_torch.ops.fbank import pad_or_trim, whisper_log_mel

                wav = torch.stack([
                    pad_or_trim(torch.from_numpy(s.waveform.astype(np.float64)))
                    for s in samples
                ])
                mel = whisper_log_mel(wav, n_mels=128).numpy()
                batch["input_features"] = np.swapaxes(mel, 1, 2)
                batch["input_feature_length"] = np.full(
                    (len(samples),), mel.shape[-1], np.int32
                )
            else:
                # waveform bucket = feature_bucket LFR frames worth of samples
                n_len = hints["n_len"]
                wav = np.stack([
                    _pad_to(s.waveform.astype(np.float32), n_len, 0.0)
                    for s in samples
                ])
                if self.cfg.waveform_dtype == "int16":
                    # halve host->device bytes; exact round trip for 16-bit
                    # PCM sources (ops/fbank.frontend rescales on device)
                    wav = np.clip(
                        np.rint(wav * 32768.0), -32768, 32767
                    ).astype(np.int16)
                batch["waveform"] = wav
                batch["waveform_length"] = np.asarray(
                    [len(s.waveform) for s in samples], np.int32
                )
            # true per-row audio duration, before padding (a host metric)
            batch["audio_seconds"] = np.asarray(
                [len(s.waveform) / 16000.0 for s in samples], np.float32
            )

        if hints["has_gt"]:
            g_len = hints["g_len"]
            batch["gt_ids"] = np.stack([
                _pad_to(s.gt_ids, g_len, 0) for s in samples
            ])
            batch["gt_lens"] = np.asarray(
                [len(s.gt_ids) for s in samples], np.int32
            )

        batch["keys"] = [s.key for s in samples]
        batch["targets"] = [s.target for s in samples]
        batch["GT"] = [s.gt for s in samples]
        return batch


class GlobalBatcher:
    """Deterministic global batching across hosts.

    Every host walks the identical manifest order and computes identical
    global buckets; the bucket is padded globally (loss-masked repeats of
    row 0, ``batch_valid``) to ``num_hosts * batch_multiple`` rows and host
    h keeps the h-th contiguous block, so the hosts' blocks laid end to
    end are the single-process batch: same rows, same order, same pad
    positions.  All hosts see the same number of steps.
    """

    def __init__(
        self, dataset: MultiTaskDataset, collator: Collator,
        max_frame_length: int, ds_rate: int,
        num_hosts: int = 1, host_id: int = 0,
        batch_multiple: int = 1,
        fixed_batch_size: Optional[int] = None,
        skip_batches: int = 0,
    ):
        self.dataset = dataset
        self.collator = collator
        self.max_frame_length = max_frame_length
        self.ds_rate = ds_rate
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.batch_multiple = batch_multiple
        self.fixed_batch_size = fixed_batch_size
        self.skip_batches = skip_batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.fixed_batch_size:
            buckets = fixed_batches(iter(self.dataset), self.fixed_batch_size)
        else:
            buckets = dynamic_batches(
                iter(self.dataset), self.max_frame_length, self.ds_rate
            )
        skipped = 0
        for bucket in buckets:
            if skipped < self.skip_batches:
                # resume fast-forward: bucketing already consumed the
                # sample stream; a marker stands in for the collated batch
                # (no decode with lazy_audio, no collation at all)
                skipped += 1
                yield {"batch_skipped": True}
                continue
            per_host = -(-len(bucket) // self.num_hosts)
            per_host = -(-per_host // self.batch_multiple) * self.batch_multiple
            total = per_host * self.num_hosts
            global_rows = bucket + [bucket[0]] * (total - len(bucket))
            global_valid = np.zeros((total,), bool)
            global_valid[: len(bucket)] = True
            lo = self.host_id * per_host
            mine = global_rows[lo: lo + per_host]
            valid = global_valid[lo: lo + per_host]
            # pad shapes/keys from the FULL global bucket, not this host's
            # slice — hosts' slices can bucket to different lengths, which
            # would compile different programs per process (see shape_hints)
            out = self.collator(mine, hints=self.collator.shape_hints(bucket))
            out["batch_valid"] = valid
            yield out


@register_dataset("multitask")
def get_speech_dataset(
    dataset_config, tokenizer, split: str, encoder_tokenizer=None,
    num_hosts: int = 1, host_id: int = 0, load_audio: bool = True,
    fixed_batch_size: Optional[int] = None, seed: int = 42,
    batch_multiple: int = 1, skip_batches: int = 0,
):
    """The batches of a manifest split.

    ``fixed_batch_size`` selects the "padding" batching strategy; None =
    token-budget dynamic batching.
    ``seed`` controls prompt choice; pass seed+epoch for fresh prompt draws
    per epoch (all hosts must agree for deterministic global batching).
    ``batch_multiple``: pad each per-host batch to this multiple (set it to
    the per-host device count; padded rows carry batch_valid=False).
    """
    ds = MultiTaskDataset(
        dataset_config, tokenizer, split,
        encoder_tokenizer=encoder_tokenizer, load_audio=load_audio,
        lazy_audio=skip_batches > 0,
        seed=seed,
    )
    inference = split == "test" or dataset_config.inference_mode
    coll = Collator(tokenizer, dataset_config, inference)
    budget = (
        dataset_config.train_max_frame_length
        if split == "train" else dataset_config.eval_max_frame_length
    )
    return GlobalBatcher(
        ds, coll, budget, dataset_config.ds_rate,
        num_hosts=num_hosts, host_id=host_id,
        batch_multiple=batch_multiple,
        fixed_batch_size=fixed_batch_size,
        skip_batches=skip_batches,
    )
