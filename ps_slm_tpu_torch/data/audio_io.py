"""Audio input: wav files, Kaldi ``ark:offset`` entries, binary matrices.

A copy of ``ps_slm_tpu/data/audio_io.py`` (the port imports nothing of the
JAX package):

  * plain ``*.wav`` / wav-in-ark at ``path:offset`` -> int16 PCM / 32768
  * Kaldi binary float matrices at ``path:offset`` (pre-computed fbank arks)
  * ``*.flac`` through ``data/flac.py``

The optional C++ helper (``native/csrc/{audio_io,flac}.cc``, found by
``data/_native_lib.py``) reads through ctypes when it is built; otherwise
the pure-Python readers run (:func:`native_available` says which).
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import numpy as np

_LIB = None
_LIB_TRIED = False


def _native():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    from ps_slm_tpu_torch.data._native_lib import find_native_lib

    cand = find_native_lib()
    if cand is None:
        return None
    try:
        lib = ctypes.CDLL(cand)
    except OSError:
        return None

    class WavMeta(ctypes.Structure):
        _fields_ = [
            ("sample_rate", ctypes.c_int32),
            ("num_channels", ctypes.c_int32),
            ("bits_per_sample", ctypes.c_int32),
            ("num_frames", ctypes.c_int64),
            ("data_offset", ctypes.c_int64),
        ]

    class MatMeta(ctypes.Structure):
        _fields_ = [
            ("rows", ctypes.c_int32),
            ("cols", ctypes.c_int32),
            ("dtype", ctypes.c_int32),
            ("data_offset", ctypes.c_int64),
        ]

    lib.ps_wav_info.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(WavMeta)
    ]
    lib.ps_wav_read.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int16),
    ]
    lib.ps_kaldi_mat_info.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(MatMeta)
    ]
    lib.ps_kaldi_mat_read.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p
    ]
    lib._WavMeta = WavMeta
    lib._MatMeta = MatMeta

    if hasattr(lib, "ps_flac_info"):
        class FlacMeta(ctypes.Structure):
            _fields_ = [
                ("sample_rate", ctypes.c_int32),
                ("num_channels", ctypes.c_int32),
                ("bits_per_sample", ctypes.c_int32),
                ("total_samples", ctypes.c_int64),
            ]

        lib.ps_flac_info.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(FlacMeta)
        ]
        lib.ps_flac_read.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ]
        lib.ps_flac_read.restype = ctypes.c_int64
        lib._FlacMeta = FlacMeta
    _LIB = lib
    return lib


def native_available() -> bool:
    """True when the C++ helper was found and loaded (it then reads the
    audio); False when the pure-Python readers do."""
    return _native() is not None


def parse_path(path: str) -> Tuple[str, int]:
    """``file.ark:12345`` -> (file, offset); plain path -> (path, 0)."""
    if ":" in path:
        head, _, tail = path.rpartition(":")
        if head and tail.isdigit():
            return head, int(tail)
    return path, 0


# ----------------------------------------------------------------------------
# wav
# ----------------------------------------------------------------------------

def read_wav(path: str, offset: int = 0) -> Tuple[int, np.ndarray]:
    """Returns (sample_rate, float32 mono in [-1, 1])."""
    lib = _native()
    if lib is not None:
        meta = lib._WavMeta()
        rc = lib.ps_wav_info(path.encode(), offset, ctypes.byref(meta))
        if rc == 0:
            n = meta.num_frames * meta.num_channels
            buf = np.empty(n, np.int16)
            rc = lib.ps_wav_read(
                path.encode(), meta.data_offset, n,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            )
            if rc == 0:
                x = buf.astype(np.float32) / 32768.0
                if meta.num_channels > 1:
                    x = x.reshape(-1, meta.num_channels).mean(axis=1)
                return meta.sample_rate, x
    return _read_wav_numpy(path, offset)


def _read_wav_numpy(path: str, offset: int = 0) -> Tuple[int, np.ndarray]:
    with open(path, "rb") as f:
        f.seek(offset)
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE stream: {path}:{offset}")
        sample_rate = channels = bits = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError(f"no data chunk in {path}:{offset}")
            cid, size = hdr[:4], int.from_bytes(hdr[4:8], "little")
            if cid == b"fmt ":
                fmt = f.read(size + (size & 1))
                audio_format = int.from_bytes(fmt[0:2], "little")
                channels = int.from_bytes(fmt[2:4], "little")
                sample_rate = int.from_bytes(fmt[4:8], "little")
                bits = int.from_bytes(fmt[14:16], "little")
                if audio_format != 1 or bits != 16:
                    raise ValueError(
                        f"only PCM16 wav supported, got fmt={audio_format} bits={bits}"
                    )
            elif cid == b"data":
                raw = f.read(size)
                x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
                if channels and channels > 1:
                    x = x.reshape(-1, channels).mean(axis=1)
                return sample_rate, x
            else:
                f.seek(size + (size & 1), 1)


def write_wav(path: str, rate: int, samples: np.ndarray) -> None:
    """Minimal PCM16 wav writer (fixtures & tests)."""
    pcm = np.clip(samples, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2").tobytes()
    hdr = (
        b"RIFF" + (36 + len(pcm)).to_bytes(4, "little") + b"WAVE"
        + b"fmt " + (16).to_bytes(4, "little")
        + (1).to_bytes(2, "little") + (1).to_bytes(2, "little")
        + rate.to_bytes(4, "little") + (rate * 2).to_bytes(4, "little")
        + (2).to_bytes(2, "little") + (16).to_bytes(2, "little")
        + b"data" + len(pcm).to_bytes(4, "little")
    )
    with open(path, "wb") as f:
        f.write(hdr + pcm)


# ----------------------------------------------------------------------------
# flac
# ----------------------------------------------------------------------------

def read_flac(path: str, offset: int = 0) -> Tuple[int, np.ndarray]:
    """Returns (sample_rate, float32 mono in [-1, 1]).

    C++ decoder (native/csrc/flac.cc) when built; pure Python
    (data/flac.py) otherwise.
    """
    lib = _native()
    if lib is not None and hasattr(lib, "ps_flac_info"):
        meta = lib._FlacMeta()
        rc = lib.ps_flac_info(path.encode(), offset, ctypes.byref(meta))
        if rc == 0 and meta.total_samples > 0:
            n = meta.total_samples * meta.num_channels
            buf = np.empty(n, np.int32)
            got = lib.ps_flac_read(
                path.encode(), offset,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
            )
            if got > 0:
                x = buf[: got * meta.num_channels].astype(np.float32)
                x /= float(1 << (meta.bits_per_sample - 1))
                if meta.num_channels > 1:
                    x = x.reshape(-1, meta.num_channels).mean(axis=1)
                return meta.sample_rate, x
    from ps_slm_tpu_torch.data.flac import read_flac as _py_read_flac

    return _py_read_flac(path, offset)


# ----------------------------------------------------------------------------
# kaldi ark
# ----------------------------------------------------------------------------

def read_kaldi_matrix(path: str, offset: int) -> np.ndarray:
    """Binary Kaldi matrix ('\\0B' + 'FM '/'DM ') at offset -> float32 [R,C]."""
    lib = _native()
    if lib is not None:
        meta = lib._MatMeta()
        rc = lib.ps_kaldi_mat_info(path.encode(), offset, ctypes.byref(meta))
        if rc == 0:
            itemsize = 4 if meta.dtype == 4 else 8
            nbytes = meta.rows * meta.cols * itemsize
            buf = ctypes.create_string_buffer(nbytes)
            rc = lib.ps_kaldi_mat_read(
                path.encode(), meta.data_offset, nbytes, buf
            )
            if rc == 0:
                dt = np.float32 if meta.dtype == 4 else np.float64
                arr = np.frombuffer(buf, dt).reshape(meta.rows, meta.cols)
                return arr.astype(np.float32)
    return _read_kaldi_matrix_numpy(path, offset)


def _read_kaldi_matrix_numpy(path: str, offset: int) -> np.ndarray:
    with open(path, "rb") as f:
        f.seek(offset)
        if f.read(2) != b"\x00B":
            raise ValueError(f"not a Kaldi binary object at {path}:{offset}")
        tok = f.read(3)
        if tok == b"FM ":
            dt, isz = np.dtype("<f4"), 4
        elif tok == b"DM ":
            dt, isz = np.dtype("<f8"), 8
        else:
            raise ValueError(f"unsupported Kaldi object {tok!r}")
        assert f.read(1) == b"\x04"
        rows = int.from_bytes(f.read(4), "little")
        assert f.read(1) == b"\x04"
        cols = int.from_bytes(f.read(4), "little")
        data = f.read(rows * cols * isz)
        return np.frombuffer(data, dt).reshape(rows, cols).astype(np.float32)


def write_kaldi_wav_ark(path: str, entries) -> dict:
    """Write a wav ark {key: (rate, float array)} -> {key: byte offset}.

    Kaldi wav-ark layout: 'key ' then the RIFF bytes; the offset stored in
    manifests points at the RIFF header.
    """
    offsets = {}
    with open(path, "wb") as f:
        for key, (rate, samples) in entries.items():
            f.write(key.encode() + b" ")
            offsets[key] = f.tell()
            pcm = (np.clip(samples, -1, 1) * 32767.0).astype("<i2").tobytes()
            hdr = (
                b"RIFF" + (36 + len(pcm)).to_bytes(4, "little") + b"WAVE"
                + b"fmt " + (16).to_bytes(4, "little")
                + (1).to_bytes(2, "little") + (1).to_bytes(2, "little")
                + rate.to_bytes(4, "little") + (rate * 2).to_bytes(4, "little")
                + (2).to_bytes(2, "little") + (16).to_bytes(2, "little")
                + b"data" + len(pcm).to_bytes(4, "little")
            )
            f.write(hdr + pcm)
    return offsets


def audio_num_samples(path: str, target_rate: int = 16000) -> int:
    """Length (in target_rate samples) that ``load_audio`` would return —
    from headers only, no sample decode.  Used by the resume fast-forward
    so skipping already-trained batches costs header reads, not full audio
    decodes; formula-identical to ``load_audio`` (same mono-mix frame
    count, same resample rounding)."""
    ext = os.path.splitext(path.split(":")[0])[1].lower()
    fpath, offset = parse_path(path)
    rate = n = None
    if ext == ".flac":
        lib = _native()
        if lib is not None and hasattr(lib, "ps_flac_info"):
            meta = lib._FlacMeta()
            rc = lib.ps_flac_info(fpath.encode(), offset, ctypes.byref(meta))
            if rc == 0 and meta.total_samples > 0:
                rate, n = meta.sample_rate, meta.total_samples
        if n is None:
            from ps_slm_tpu_torch.data.flac import stream_info

            r, _, _, total = stream_info(fpath, offset)
            if total > 0:
                rate, n = r, total
    else:
        lib = _native()
        if lib is not None:
            meta = lib._WavMeta()
            rc = lib.ps_wav_info(fpath.encode(), offset, ctypes.byref(meta))
            if rc == 0:
                rate, n = meta.sample_rate, meta.num_frames
        if n is None:
            with open(fpath, "rb") as f:
                f.seek(offset)
                riff = f.read(12)
                if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
                    raise ValueError(
                        f"not a RIFF/WAVE stream: {fpath}:{offset}"
                    )
                channels = rate = None
                while True:
                    hdr = f.read(8)
                    if len(hdr) < 8:
                        raise ValueError(f"no data chunk in {fpath}:{offset}")
                    cid = hdr[:4]
                    size = int.from_bytes(hdr[4:8], "little")
                    if cid == b"fmt ":
                        fmt = f.read(size + (size & 1))
                        channels = int.from_bytes(fmt[2:4], "little")
                        rate = int.from_bytes(fmt[4:8], "little")
                    elif cid == b"data":
                        n = size // (2 * max(channels or 1, 1))
                        break
                    else:
                        f.seek(size + (size & 1), 1)
    if n is None:
        # unknown-length stream (e.g. FLAC total_samples=0): decode
        return len(load_audio(path, target_rate))
    if rate != target_rate:
        n = int(round(n * target_rate / rate))
    return n


def load_audio(path: str, target_rate: int = 16000) -> np.ndarray:
    """Resolve a manifest `path` field to float32 mono at target_rate.

    wav and wav-in-ark as int16 / 32768, flac through data/flac.py; other
    rates resampled linearly on the host.
    """
    ext = os.path.splitext(path.split(":")[0])[1].lower()
    fpath, offset = parse_path(path)
    if ext == ".flac":
        rate, x = read_flac(fpath, offset)
    else:
        rate, x = read_wav(fpath, offset)
    if rate != target_rate:
        # linear resample (host, rare path; reference assumes 16 kHz input)
        n_out = int(round(len(x) * target_rate / rate))
        xp = np.linspace(0.0, 1.0, len(x), endpoint=False)
        xq = np.linspace(0.0, 1.0, n_out, endpoint=False)
        x = np.interp(xq, xp, x).astype(np.float32)
    return x
