"""Static-batch server: the slot pools' ``run(requests)`` contract over
batched ``generate``.

Counterpart of ``ps_slm_tpu/inference/static_serve.py``.  Single-request
payloads are grouped ``decode_slots`` at a time
and decoded by the static path (:func:`~ps_slm_tpu_torch.inference.generate.generate`),
whose one prefill and few steps a group cost less than the pool's per-slot
work when completions are short; ``cli/serve.py`` routes between the two.

Shapes follow the dataset's buckets: within a group, input ids are
left-padded to the token bucket, features right-padded to the feature
bucket, waveforms to whole seconds (16 000 samples), and the batch axis is
filled by replicating real rows, whose outputs are dropped.  The eager
port compiles nothing, but the buckets fix the left padding, so the texts
equal the JAX package's.  Waveforms keep their wire dtype (int16 PCM
stays int16 and the front end rescales it); the JAX package's stacking
casts them to float32 without the rescale.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ps_slm_tpu_torch._build import resolve_device


def _round_up(n: int, b: int) -> int:
    return -(-max(n, 1) // b) * b


# the collator's rule, along axis 1: left-padded (``input_ids`` with the
# pad id, ``attention_mask`` with False), right-padded with zeros
LEFT_PADDED = frozenset({"input_ids", "attention_mask"})
RIGHT_PADDED = frozenset({"input_features", "waveform", "gt_ids"})


def pad_rows(rows, pad_id: int,
             buckets: Optional[Dict[str, int]] = None) -> Dict[str, torch.Tensor]:
    """Single-row batches with one key set as one batch, by the collator's
    rule (``data/dataset.py::Collator``): the keys of :data:`LEFT_PADDED`
    and :data:`RIGHT_PADDED` padded to their longest row, rounded up to
    ``buckets[key]`` (default 1); every other key (the lengths,
    ``audio_seconds``) concatenated."""
    out = {}
    for key in rows[0]:
        parts = [r[key] for r in rows]
        if key not in LEFT_PADDED and key not in RIGHT_PADDED:
            out[key] = torch.cat(parts)
            continue
        width = _round_up(max(p.shape[1] for p in parts), (buckets or {}).get(key, 1))
        buf = parts[0].new_full((len(parts), width) + tuple(parts[0].shape[2:]),
                                pad_id if key == "input_ids" else 0)
        for i, p in enumerate(parts):
            if key in LEFT_PADDED:
                buf[i, width - p.shape[1]:] = p[0]
            else:
                buf[i, :p.shape[1]] = p[0]
        out[key] = buf
    return out


class StaticBatchDecoder:
    """Groups single-request payloads (``(key, batch)`` with batch rows of
    1) and decodes each group with the static ``generate``."""

    def __init__(self, model, tc, dc, *, eos_token_id: int, device="cuda"):
        self.model = model
        self.tc = tc
        self.eos = eos_token_id
        self.device = resolve_device(device)
        self.batch_size = tc.decode_slots
        self.token_bucket = max(getattr(dc, "token_bucket", 8) or 8, 1)
        self.feature_bucket = max(getattr(dc, "feature_bucket", 16) or 16, 1)
        self.wave_bucket = 16000   # waveforms bucket at 1 s (16 kHz)

    # -- batching -----------------------------------------------------------
    def _stack(self, group) -> Tuple[Dict[str, torch.Tensor], int]:
        """One padded batch of ``decode_slots`` rows from single-row payloads,
        and the number of real rows: :func:`pad_rows` at the dataset's
        buckets, one audio kind kept (features before waveforms), its
        lengths int32 (a waveform length at least 1)."""
        pad_id = int(getattr(self.model, "pad_token_id", 0) or 0)
        b, n = self.batch_size, len(group)
        # fill the batch axis with copies of real rows (outputs dropped):
        # all-pad rows would send degenerate shapes through merge and CTC
        rows = [group[i % n][1] for i in range(b)]
        keys = ["input_ids", "attention_mask"]
        for audio, length in (("input_features", "input_feature_length"),
                              ("waveform", "waveform_length")):
            if any(audio in g for g in rows):
                keys += [audio, length]
                break
        batch = pad_rows([{k: g[k] for k in keys} for g in rows], pad_id, buckets={
            "input_ids": self.token_bucket, "attention_mask": self.token_bucket,
            "input_features": self.feature_bucket, "waveform": self.wave_bucket})
        batch["attention_mask"] = batch["attention_mask"].bool()
        if "input_features" in batch:
            batch["input_features"] = batch["input_features"].to(
                self.model.llm.embed_tokens.weight.dtype)
            batch["input_feature_length"] = batch["input_feature_length"].to(torch.int32)
        elif "waveform" in batch:
            # a zero-length row would give the front end no frames
            batch["waveform_length"] = batch["waveform_length"].to(torch.int32).clamp(min=1)
        return batch, n

    @staticmethod
    def _payload_kind(g) -> str:
        if "input_features" in g:
            return "input_features"
        if "waveform" in g:
            return "waveform"
        return "text"

    def _decode_group(self, group) -> Iterator[Tuple[str, np.ndarray]]:
        """Decode ``group``, split by payload kind first: :meth:`_stack`
        takes one kind a batch."""
        kinds = {self._payload_kind(g) for _, g in group}
        if len(kinds) > 1:
            for kind in sorted(kinds):
                yield from self._decode_group(
                    [item for item in group if self._payload_kind(item[1]) == kind])
            return
        yield from self._decode_uniform(group)

    def _decode_uniform(self, group) -> Iterator[Tuple[str, np.ndarray]]:
        from ps_slm_tpu_torch.inference.generate import generate

        tc = self.tc
        batch, n = self._stack(group)
        out = generate(
            self.model, batch, eos_token_id=self.eos, device=self.device,
            num_beams=tc.num_beams, max_new_tokens=tc.max_new_tokens, do_sample=tc.do_sample,
            min_length=tc.min_length, top_p=tc.top_p, temperature=tc.temperature,
            length_penalty=tc.length_penalty, repetition_penalty=tc.repetition_penalty,
            kv_bits=tc.kv_cache_bits,
        ).cpu().numpy()
        for i in range(n):
            yield group[i][0], out[i][out[i] != self.eos].astype(np.int32)

    # -- the pools' entry point ---------------------------------------------
    def run(self, batches: Iterator[Optional[Tuple[str, Dict]]], stop_after=None,
            on_partial=None) -> Iterator[Tuple[str, np.ndarray]]:
        """The pools' contract: consume ``(key, batch)`` items, yield
        ``(key, tokens)`` (EOS left out).  ``None`` (a live source with
        nothing ready) decodes the partial group at once, so a trickle of
        requests is served at its own pace."""
        if stop_after:
            raise ValueError("StaticBatchDecoder does not support stop_after")
        if on_partial is not None:
            raise ValueError("StaticBatchDecoder does not support on_partial; streaming "
                             "requests route to the slot pool")
        group = []
        for item in batches:
            if item is None:
                if group:
                    yield from self._decode_group(group)
                    group = []
                else:
                    time.sleep(0.001)
                continue
            group.append(item)
            if len(group) >= self.batch_size:
                yield from self._decode_group(group)
                group = []
        if group:
            yield from self._decode_group(group)
