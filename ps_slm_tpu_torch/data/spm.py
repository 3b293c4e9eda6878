"""SentencePiece-compatible BPE tokenizer (no sentencepiece dependency).

A copy of ``ps_slm_tpu/data/spm.py`` (the port imports nothing of the JAX
package): the SenseVoice BPE model (vocab 25 055, blank id 0) read and
applied without the sentencepiece library:

  * a minimal reader of the sentencepiece ``ModelProto`` wire format
    (field 1 = repeated SentencePiece{piece:1 string, score:2 float,
    type:3 enum}; trainer/normalizer specs are skipped),
  * greedy highest-score-pair BPE encoding with byte-fallback, matching
    sentencepiece's BPE-model semantics (whitespace is pre-split and
    re-marked with U+2581).

A C++ implementation of the same encoder lives in ``native/csrc`` (used when
built, found by ``data/_native_lib.py``); this file is the always-available
implementation and the binding surface.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

_WS = "▁"  # sentencepiece whitespace marker

# SentencePiece piece types (sentencepiece.proto)
TYPE_NORMAL = 1
TYPE_UNKNOWN = 2
TYPE_CONTROL = 3
TYPE_USER_DEFINED = 4
TYPE_BYTE = 6
TYPE_UNUSED = 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:
        pos += 8
    elif wire_type == 2:
        ln, pos = _read_varint(buf, pos)
        pos += ln
    elif wire_type == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    return pos


def _parse_piece(buf: bytes) -> Tuple[str, float, int]:
    pos = 0
    piece, score, ptype = "", 0.0, TYPE_NORMAL
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if field == 1 and wt == 2:
            ln, pos = _read_varint(buf, pos)
            piece = buf[pos:pos + ln].decode("utf-8", errors="replace")
            pos += ln
        elif field == 2 and wt == 5:
            (score,) = struct.unpack("<f", buf[pos:pos + 4])
            pos += 4
        elif field == 3 and wt == 0:
            ptype, pos = _read_varint(buf, pos)
        else:
            pos = _skip_field(buf, pos, wt)
    return piece, score, ptype


def parse_model_proto(data: bytes) -> List[Tuple[str, float, int]]:
    """ModelProto -> [(piece, score, type)] in vocab-id order."""
    pieces = []
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wt = tag >> 3, tag & 7
        if field == 1 and wt == 2:
            ln, pos = _read_varint(data, pos)
            pieces.append(_parse_piece(data[pos:pos + ln]))
            pos += ln
        else:
            pos = _skip_field(data, pos, wt)
    return pieces


def serialize_model_proto(pieces: List[Tuple[str, float, int]]) -> bytes:
    """Inverse of :func:`parse_model_proto` (tests, tooling)."""
    def varint(v: int) -> bytes:
        out = b""
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b | 0x80])
            else:
                return out + bytes([b])

    blob = b""
    for piece, score, ptype in pieces:
        pb = piece.encode("utf-8")
        body = (
            bytes([0x0A]) + varint(len(pb)) + pb
            + bytes([0x15]) + struct.pack("<f", score)
            + bytes([0x18]) + varint(ptype)
        )
        blob += bytes([0x0A]) + varint(len(body)) + body
    return blob


class SentencePieceBPE:
    """BPE encoder/decoder over a sentencepiece ModelProto."""

    def __init__(self, model_path_or_bytes):
        if isinstance(model_path_or_bytes, (bytes, bytearray)):
            data = bytes(model_path_or_bytes)
        else:
            with open(model_path_or_bytes, "rb") as f:
                data = f.read()
        self.pieces = parse_model_proto(data)
        self.piece_to_id: Dict[str, int] = {}
        self.scores: Dict[str, float] = {}
        self.unk_id = 0
        self.byte_ids: Dict[int, int] = {}
        for i, (piece, score, ptype) in enumerate(self.pieces):
            if piece not in self.piece_to_id:
                self.piece_to_id[piece] = i
                self.scores[piece] = score
            if ptype == TYPE_UNKNOWN:
                self.unk_id = i
            if ptype == TYPE_BYTE:
                # "<0xNN>"
                self.byte_ids[int(piece[3:5], 16)] = i

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    def id_to_piece(self, i: int) -> str:
        return self.pieces[i][0]

    # -- encoding ------------------------------------------------------------

    def _encode_word(self, word: str) -> List[int]:
        """Greedy best-score-pair merges (sentencepiece BPE semantics)."""
        symbols = list(word)
        if not symbols:
            return []
        while True:
            best_score, best_idx = None, None
            for i in range(len(symbols) - 1):
                cand = symbols[i] + symbols[i + 1]
                sc = self.scores.get(cand)
                if sc is not None and (best_score is None or sc > best_score):
                    best_score, best_idx = sc, i
            if best_idx is None:
                break
            symbols[best_idx: best_idx + 2] = [
                symbols[best_idx] + symbols[best_idx + 1]
            ]
        ids: List[int] = []
        for sym in symbols:
            pid = self.piece_to_id.get(sym)
            if pid is not None:
                ids.append(pid)
            elif self.byte_ids:
                ids.extend(
                    self.byte_ids.get(b, self.unk_id) for b in sym.encode()
                )
            else:
                ids.append(self.unk_id)
        return ids

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in text.split(" "):
            if not word:
                continue
            ids.extend(self._encode_word(_WS + word))
        return ids

    def decode(self, ids: List[int]) -> str:
        out: List[str] = []
        byte_buf: List[int] = []

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            piece, _, ptype = self.pieces[i]
            if ptype == TYPE_BYTE:
                byte_buf.append(int(piece[3:5], 16))
                continue
            flush()
            if ptype in (TYPE_CONTROL, TYPE_UNKNOWN):
                continue
            out.append(piece)
        flush()
        return "".join(out).replace(_WS, " ").strip()


class _NativeSPM:
    """ctypes binding to the C++ encoder (native/csrc/spm_bpe.cc)."""

    def __init__(self, model_path: str, lib):
        import ctypes

        self._lib = lib
        self._h = lib.ps_spm_load(model_path.encode())
        if not self._h:
            raise OSError(f"native spm failed to load {model_path}")
        self._ctypes = ctypes

    @property
    def vocab_size(self) -> int:
        return self._lib.ps_spm_vocab_size(self._h)

    def encode(self, text: str) -> List[int]:
        ct = self._ctypes
        n = max(len(text) * 4 + 8, 64)
        buf = (ct.c_int * n)()
        got = self._lib.ps_spm_encode(self._h, text.encode(), buf, n)
        if got > n:  # retry with exact size
            buf = (ct.c_int * got)()
            got = self._lib.ps_spm_encode(self._h, text.encode(), buf, got)
        return list(buf[:got])

    def __del__(self):
        try:
            self._lib.ps_spm_free(self._h)
        except Exception:
            pass


def load_bpe(model_path: str, prefer_native: bool = True):
    """Load the BPE encoder; C++ when built, Python otherwise."""
    if prefer_native:
        try:
            import ctypes

            from ps_slm_tpu_torch.data._native_lib import find_native_lib

            so = find_native_lib()
            if so is not None:
                lib = ctypes.CDLL(so)
                lib.ps_spm_load.restype = ctypes.c_void_p
                lib.ps_spm_load.argtypes = [ctypes.c_char_p]
                lib.ps_spm_free.argtypes = [ctypes.c_void_p]
                lib.ps_spm_vocab_size.argtypes = [ctypes.c_void_p]
                lib.ps_spm_encode.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                ]
                native = _NativeSPM(model_path, lib)
                # python twin kept for decode()/pieces access
                native_py = SentencePieceBPE(model_path)
                native.decode = native_py.decode
                native.pieces = native_py.pieces
                native.id_to_piece = native_py.id_to_piece
                return native
        except Exception:
            pass
    return SentencePieceBPE(model_path)


class SenseVoiceTokenizer:
    """Encoder-vocab tokenizer for pseudo-posterior simulation.

    Loads ``chn_jpn_yue_eng_ko_spectok.bpe.model`` from ``model_dir``;
    pad/eos filtered on decode; blank id 0.
    """

    def __init__(self, model_dir: str):
        import os

        self.sp = load_bpe(
            os.path.join(model_dir, "chn_jpn_yue_eng_ko_spectok.bpe.model")
        )
        self.pad_id = -1
        self.eos_id = -1
        for i, (piece, _, ptype) in enumerate(self.sp.pieces):
            if piece == "<pad>":
                self.pad_id = i
            if piece == "</s>":
                self.eos_id = i

    @property
    def vocab_size(self) -> int:
        return self.sp.vocab_size

    def encode(self, text: str) -> List[int]:
        return self.sp.encode(text)

    def decode(self, ids: List[int]) -> str:
        return self.sp.decode(
            [i for i in ids if i not in (self.pad_id, self.eos_id)]
        )
