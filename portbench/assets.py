"""Frozen stand-ins for the recipes' assets.

A copy of what the benchmark needs of ``ps_slm_tpu_torch/tools/_assets.py``
and of ``chip_smoke.py``'s BPE writer, so that a change to the port cannot
move the yardstick:

* an HF tokenizer directory for the LLM: the 256 byte tokens at ids 0-255,
  no merges, Qwen2.5's three special tokens at their ids, ``<|im_end|>``
  as EOS (no weights: the benchmark loads its own);
* the encoder's SentencePiece BPE model: blank, unk, ``</s>``, the
  whitespace mark and the 26 letters, then filler pieces up to the
  encoder's vocabulary;
* a Kaldi ``wav.ark`` of 16 kHz int16 utterances and a ``multitask.jsonl``
  manifest over it.

``token_ids`` is the reference's own tokenizer of that LLM vocabulary: a
text's UTF-8 bytes, with the special tokens at their ids.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterable, List, Tuple

import numpy as np

QWEN_SPECIALS = {"<|endoftext|>": 151643, "<|im_start|>": 151644, "<|im_end|>": 151645}
# the tokenizer adds <speech> after the largest id it holds
SPEECH_TOKEN = "<speech>"
SPECIAL_IDS = dict(QWEN_SPECIALS, **{SPEECH_TOKEN: 151646})
EOS = "<|im_end|>"
BPE_FILE = "chn_jpn_yue_eng_ko_spectok.bpe.model"
LETTERS = "▁abcdefghijklmnopqrstuvwxyz"


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def write_llm_tokenizer(path: str) -> str:
    """The byte-level tokenizer directory (module docstring)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({c: b for b, c in sorted(bytes_to_unicode().items())}, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "Qwen2Tokenizer", "eos_token": EOS,
                   "pad_token": "<|endoftext|>",
                   "added_tokens_decoder": {str(i): {"content": t, "special": True}
                                            for t, i in QWEN_SPECIALS.items()}}, f)
    return path


def token_ids(text: str) -> List[int]:
    """The reference tokenizer: special tokens at their ids, every other
    character as its UTF-8 bytes."""
    out: List[int] = []
    i = 0
    while i < len(text):
        for tok, tid in SPECIAL_IDS.items():
            if text.startswith(tok, i):
                out.append(tid)
                i += len(tok)
                break
        else:
            out.extend(text[i].encode("utf-8"))
            i += 1
    return out


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def bpe_pieces(vocab: int, labels: bool = False) -> List[Tuple[str, float, int]]:
    """(piece, score, type) of the stand-in BPE model; type 3 control, 2
    unknown, 1 normal.  ``labels``: every label but the blank a word of its
    own, ``w<id>``, so that a decoded text names its labels."""
    if labels:
        return [("<blank>", 0.0, 3)] + [(f"▁w{i}", -1.0, 1) for i in range(1, vocab)]
    pieces = [("<blank>", 0.0, 3), ("<unk>", 0.0, 2), ("</s>", 0.0, 3)]
    pieces += [(c, -1.0, 1) for c in LETTERS]
    pieces += [(f"▁{i}", -2.0, 1) for i in range(vocab - len(pieces))]
    return pieces


def write_bpe_model(path: str, vocab: int, labels: bool = False) -> str:
    """The SentencePiece ``ModelProto`` of :func:`bpe_pieces` in ``path``."""
    os.makedirs(path, exist_ok=True)
    blob = b""
    for piece, score, ptype in bpe_pieces(vocab, labels):
        pb = piece.encode("utf-8")
        body = (b"\x0a" + _varint(len(pb)) + pb + b"\x15" + struct.pack("<f", score)
                + b"\x18" + _varint(ptype))
        blob += b"\x0a" + _varint(len(body)) + body
    with open(os.path.join(path, BPE_FILE), "wb") as f:
        f.write(blob)
    return path


def bpe_ids(text: str) -> List[int]:
    """The reference's encoding of a lower-case transcript with the stand-in
    BPE model: a word is the whitespace mark then its letters, one piece
    each (no pair of the stand-in's pieces merges)."""
    index = {c: 3 + i for i, c in enumerate(LETTERS)}
    out: List[int] = []
    for word in text.split():
        out.append(index["▁"])
        out.extend(index[c] for c in word)
    return out


def _riff(pcm: bytes, rate: int = 16000) -> bytes:
    return (b"RIFF" + (36 + len(pcm)).to_bytes(4, "little") + b"WAVE"
            + b"fmt " + (16).to_bytes(4, "little") + (1).to_bytes(2, "little")
            + (1).to_bytes(2, "little") + rate.to_bytes(4, "little")
            + (rate * 2).to_bytes(4, "little") + (2).to_bytes(2, "little")
            + (16).to_bytes(2, "little") + b"data" + len(pcm).to_bytes(4, "little") + pcm)


def write_wav_ark(path: str, entries: Iterable[Tuple[str, np.ndarray]]) -> Dict[str, int]:
    """A Kaldi wav ark of ``(key, int16 samples)``: ``key `` then the RIFF
    bytes; returns each key's offset of its RIFF header."""
    offsets = {}
    with open(path, "wb") as f:
        for key, samples in entries:
            f.write(key.encode() + b" ")
            offsets[key] = f.tell()
            f.write(_riff(np.asarray(samples, "<i2").tobytes()))
    return offsets


def write_manifest(path: str, rows: Iterable[dict]) -> str:
    """``path/multitask.jsonl``, one JSON object a row."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "multitask.jsonl"), "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return path
