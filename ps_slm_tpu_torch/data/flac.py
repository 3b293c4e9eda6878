"""FLAC codec in pure Python (the C++ helper has one in native/csrc/flac.cc).

A copy of ``ps_slm_tpu/data/flac.py`` (the port imports nothing of the JAX
package).  The decoder implements the full frame spec used by
libFLAC encodes: CONSTANT / VERBATIM / FIXED(0-4) / LPC subframes, 4- and
5-bit rice residuals with escape partitions, wasted bits, and all four
channel assignments (independent, left/side, right/side, mid/side).

The encoder is deliberately minimal (16-bit PCM, independent channels,
fixed predictors orders 0-2, single rice partition): it exists so tests can
produce genuine FLAC bitstreams without external tools, and so wav<->flac
fixture twins decode bit-identically.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


class BitReader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos_bytes: int = 0):
        self.data = data
        self.pos = pos_bytes * 8  # bit position

    def read(self, n: int) -> int:
        """Read n bits MSB-first."""
        out = 0
        pos = self.pos
        data = self.data
        end = pos + n
        if end > len(data) * 8:
            raise EOFError("flac: bitstream exhausted")
        while n > 0:
            byte = data[pos >> 3]
            avail = 8 - (pos & 7)
            take = avail if avail < n else n
            shift = avail - take
            out = (out << take) | ((byte >> shift) & ((1 << take) - 1))
            pos += take
            n -= take
        self.pos = pos
        return out

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def read_unary(self) -> int:
        """Count 0 bits until the terminating 1."""
        pos = self.pos
        data = self.data
        count = 0
        nbits = len(data) * 8
        while True:
            if pos >= nbits:
                raise EOFError("flac: bitstream exhausted in unary")
            byte = data[pos >> 3]
            rem = 8 - (pos & 7)
            chunk = byte & ((1 << rem) - 1)
            if chunk == 0:
                count += rem
                pos += rem
                continue
            lead = rem - chunk.bit_length()
            count += lead
            pos += lead + 1
            break
        self.pos = pos
        return count

    def align(self):
        self.pos = (self.pos + 7) & ~7

    def byte_pos(self) -> int:
        return self.pos >> 3


def _read_utf8_coded(br: BitReader) -> int:
    """Frame/sample number: UTF-8-style variable length (up to 7 bytes)."""
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n = 0
    mask = 0x40
    while b0 & mask:
        n += 1
        mask >>= 1
    v = b0 & (mask - 1)
    for _ in range(n):
        v = (v << 6) | (br.read(8) & 0x3F)
    return v


BLOCK_SIZE_TABLE = [
    0, 192, 576, 1152, 2304, 4608, -1, -2,  # -1: 8-bit-1, -2: 16-bit-1
    256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
]
SAMPLE_RATE_TABLE = [
    0, 88200, 176400, 192000, 8000, 16000, 22050, 24000,
    32000, 44100, 48000, 96000, -1, -2, -3, 0,  # -1 kHz8, -2 Hz16, -3 Hz16*10
]
SAMPLE_SIZE_TABLE = [0, 8, 12, 0, 16, 20, 24, 32]


def _decode_residual(br: BitReader, block_size: int, order: int) -> List[int]:
    method = br.read(2)
    if method > 1:
        raise ValueError(f"flac: reserved residual method {method}")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    part_order = br.read(4)
    n_parts = 1 << part_order
    part_samples = block_size >> part_order
    res: List[int] = []
    for p in range(n_parts):
        n = part_samples - (order if p == 0 else 0)
        param = br.read(plen)
        if param == escape:
            bits = br.read(5)
            if bits == 0:
                res.extend([0] * n)
            else:
                for _ in range(n):
                    res.append(br.read_signed(bits))
        else:
            for _ in range(n):
                q = br.read_unary()
                v = (q << param) | br.read(param) if param else q
                res.append((v >> 1) ^ -(v & 1))  # zigzag
    return res


def _decode_subframe(br: BitReader, block_size: int, bps: int) -> np.ndarray:
    if br.read(1) != 0:
        raise ValueError("flac: invalid subframe padding bit")
    sftype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
        bps -= wasted

    if sftype == 0:  # CONSTANT
        v = br.read_signed(bps)
        out = np.full(block_size, v, np.int64)
    elif sftype == 1:  # VERBATIM
        out = np.array(
            [br.read_signed(bps) for _ in range(block_size)], np.int64
        )
    elif 8 <= sftype <= 12:  # FIXED
        order = sftype - 8
        warm = [br.read_signed(bps) for _ in range(order)]
        res = _decode_residual(br, block_size, order)
        coefs = FIXED_COEFFS[order]
        x = warm + [0] * (block_size - order)
        for i in range(order, block_size):
            acc = res[i - order]
            for j, c in enumerate(coefs):
                acc += c * x[i - 1 - j]
            x[i] = acc
        out = np.asarray(x, np.int64)
    elif sftype >= 32:  # LPC
        order = sftype - 31
        warm = [br.read_signed(bps) for _ in range(order)]
        precision = br.read(4) + 1
        if precision == 16:
            raise ValueError("flac: invalid LPC precision escape")
        shift = br.read_signed(5)
        coefs = [br.read_signed(precision) for _ in range(order)]
        res = _decode_residual(br, block_size, order)
        x = warm + [0] * (block_size - order)
        for i in range(order, block_size):
            acc = 0
            for j, c in enumerate(coefs):
                acc += c * x[i - 1 - j]
            x[i] = res[i - order] + (acc >> shift)
        out = np.asarray(x, np.int64)
    else:
        raise ValueError(f"flac: reserved subframe type {sftype}")

    if wasted:
        out = out << wasted
    return out


def _decode_frame(
    br: BitReader, strm_bps: int, strm_channels: int
) -> Tuple[np.ndarray, int]:
    """Decode one frame. Returns (samples [block, channels] int32, rate)."""
    sync = br.read(14)
    if sync != 0x3FFE:
        raise ValueError(f"flac: bad frame sync 0x{sync:x}")
    br.read(1)  # reserved
    br.read(1)  # blocking strategy
    bs_code = br.read(4)
    sr_code = br.read(4)
    ch_code = br.read(4)
    ss_code = br.read(3)
    br.read(1)  # reserved
    _read_utf8_coded(br)

    block_size = BLOCK_SIZE_TABLE[bs_code]
    if block_size == -1:
        block_size = br.read(8) + 1
    elif block_size == -2:
        block_size = br.read(16) + 1
    elif block_size == 0:
        raise ValueError("flac: reserved block size code")

    rate = SAMPLE_RATE_TABLE[sr_code]
    if rate == -1:
        rate = br.read(8) * 1000
    elif rate == -2:
        rate = br.read(16)
    elif rate == -3:
        rate = br.read(16) * 10

    bps = SAMPLE_SIZE_TABLE[ss_code] or strm_bps
    br.read(8)  # header CRC-8 (not verified)

    if ch_code < 8:
        n_ch = ch_code + 1
        chans = [_decode_subframe(br, block_size, bps) for _ in range(n_ch)]
    elif ch_code == 8:  # left/side
        left = _decode_subframe(br, block_size, bps)
        side = _decode_subframe(br, block_size, bps + 1)
        chans = [left, left - side]
    elif ch_code == 9:  # right/side
        side = _decode_subframe(br, block_size, bps + 1)
        right = _decode_subframe(br, block_size, bps)
        chans = [right + side, right]
    elif ch_code == 10:  # mid/side
        mid = _decode_subframe(br, block_size, bps)
        side = _decode_subframe(br, block_size, bps + 1)
        mid2 = (mid << 1) | (side & 1)
        chans = [(mid2 + side) >> 1, (mid2 - side) >> 1]
    else:
        raise ValueError(f"flac: reserved channel assignment {ch_code}")

    br.align()
    br.read(16)  # frame CRC-16 (not verified)
    return np.stack(chans, axis=1).astype(np.int32), rate


def _parse_streaminfo(block: bytes) -> Tuple[int, int, int, int]:
    """(rate, channels, bps, total_samples) from a STREAMINFO block."""
    if len(block) < 18:
        raise ValueError("flac: truncated STREAMINFO")
    bits = int.from_bytes(block[10:18], "big")
    rate = (bits >> 44) & 0xFFFFF
    channels = ((bits >> 41) & 0x7) + 1
    bps = ((bits >> 36) & 0x1F) + 1
    total = bits & ((1 << 36) - 1)
    return rate, channels, bps, total


def stream_info(path: str, offset: int = 0) -> Tuple[int, int, int, int]:
    """STREAMINFO only — (rate, channels, bps, total_samples) without
    decoding any frame.  total_samples may be 0 (= unknown per spec)."""
    with open(path, "rb") as f:
        f.seek(offset)
        if f.read(4) != b"fLaC":
            raise ValueError(f"not a FLAC stream: {path}:{offset}")
        streaminfo = None
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                break
            last = hdr[0] & 0x80
            btype = hdr[0] & 0x7F
            length = int.from_bytes(hdr[1:4], "big")
            block = f.read(length)
            if btype == 0:
                streaminfo = block
            if last:
                break
    if streaminfo is None:
        raise ValueError("flac: missing STREAMINFO")
    return _parse_streaminfo(streaminfo)


def read_flac(path: str, offset: int = 0) -> Tuple[int, np.ndarray]:
    """Decode a FLAC file. Returns (sample_rate, float32 mono in [-1, 1])."""
    with open(path, "rb") as f:
        f.seek(offset)
        data = f.read()
    if data[:4] != b"fLaC":
        raise ValueError(f"not a FLAC stream: {path}:{offset}")
    pos = 4
    streaminfo = None
    while True:
        if pos + 4 > len(data):
            raise ValueError(f"flac: truncated metadata: {path}:{offset}")
        hdr = data[pos]
        last = hdr & 0x80
        btype = hdr & 0x7F
        length = int.from_bytes(data[pos + 1: pos + 4], "big")
        if btype == 0:
            streaminfo = data[pos + 4: pos + 4 + length]
        pos += 4 + length
        if last:
            break
    if streaminfo is None:
        raise ValueError("flac: missing STREAMINFO")
    rate, channels, bps, total = _parse_streaminfo(streaminfo)

    br = BitReader(data, pos)
    blocks = []
    got = 0
    while (total == 0 or got < total) and br.byte_pos() < len(data):
        block, frate = _decode_frame(br, bps, channels)
        blocks.append(block)
        got += block.shape[0]
        rate = frate or rate
    samples = np.concatenate(blocks, axis=0)
    if total:
        samples = samples[:total]
    x = samples.astype(np.float32) / float(1 << (bps - 1))
    if x.shape[1] > 1:
        x = x.mean(axis=1)
    else:
        x = x[:, 0]
    return rate, x


# ----------------------------------------------------------------------------
# minimal encoder (test fixtures)
# ----------------------------------------------------------------------------

class BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nacc = 0

    def write(self, v: int, n: int):
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nacc += n
        while self.nacc >= 8:
            self.nacc -= 8
            self.buf.append((self.acc >> self.nacc) & 0xFF)
        self.acc &= (1 << self.nacc) - 1

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self):
        if self.nacc:
            self.write(0, 8 - self.nacc)

    def bytes(self) -> bytes:
        assert self.nacc == 0
        return bytes(self.buf)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


def _encode_subframe(bw: BitWriter, x: np.ndarray, bps: int):
    """Fixed-predictor subframe, best order in 0..2, one rice partition."""
    xi = [int(v) for v in x]
    n = len(xi)
    best = None
    for order in range(0, 3):
        if n <= order:
            continue
        coefs = FIXED_COEFFS[order]
        res = []
        for i in range(order, n):
            acc = xi[i]
            for j, c in enumerate(coefs):
                acc -= c * xi[i - 1 - j]
            res.append(acc)
        cost = sum(abs(r) for r in res)
        if best is None or cost < best[2]:
            best = (order, res, cost)
    order, res, _ = best

    bw.write(0, 1)                      # padding
    bw.write(8 + order, 6)              # FIXED type
    bw.write(0, 1)                      # no wasted bits
    for i in range(order):
        bw.write(xi[i], bps)
    # rice param from mean |residual|
    mean = (sum(abs(r) for r in res) / max(len(res), 1)) if res else 0
    param = 0
    while (1 << param) < mean + 1 and param < 14:
        param += 1
    bw.write(0, 2)                      # method: 4-bit rice
    bw.write(0, 4)                      # partition order 0
    bw.write(param, 4)
    for r in res:
        z = (abs(r) << 1) - (1 if r < 0 else 0)  # zigzag
        bw.write_unary(z >> param)
        if param:
            bw.write(z & ((1 << param) - 1), param)


def write_flac(path: str, rate: int, samples: np.ndarray,
               block_size: int = 4096) -> None:
    """Encode float32 [-1,1] mono (or [N,C]) as a 16-bit FLAC file."""
    if samples.ndim == 1:
        samples = samples[:, None]
    # int16 quantization as the exact inverse of the decode-side /32768, so
    # samples that came from int16 PCM round-trip bit-exactly
    pcm = np.clip(np.round(samples * 32768.0), -32768, 32767).astype(np.int32)
    total, n_ch = pcm.shape

    out = bytearray(b"fLaC")
    streaminfo = bytearray()
    streaminfo += struct.pack(">HH", block_size, block_size)
    streaminfo += b"\x00\x00\x00" * 2  # min/max framesize unknown
    bits = (rate << 44) | ((n_ch - 1) << 41) | ((16 - 1) << 36) | total
    streaminfo += bits.to_bytes(8, "big")
    streaminfo += b"\x00" * 16  # md5 unset
    out += bytes([0x80]) + len(streaminfo).to_bytes(3, "big") + streaminfo

    frame_no = 0
    for start in range(0, total, block_size):
        block = pcm[start: start + block_size]
        bs = block.shape[0]
        hdr = BitWriter()
        hdr.write(0x3FFE, 14)
        hdr.write(0, 1)
        hdr.write(0, 1)                  # fixed blocksize strategy
        hdr.write(7, 4)                  # block size: 16-bit - 1 follows
        hdr.write(5 if rate == 16000 else 13, 4)  # 16 kHz table / 16-bit Hz
        hdr.write(n_ch - 1, 4)           # independent channels
        hdr.write(4, 3)                  # 16 bps
        hdr.write(0, 1)
        # utf8-coded frame number (fits 7 bits for fixtures)
        assert frame_no < 128
        hdr.write(frame_no, 8)
        hdr.write(bs - 1, 16)
        if rate != 16000:
            hdr.write(rate, 16)
        hdr.align()
        hdr_bytes = hdr.bytes()
        hdr_bytes += bytes([_crc8(hdr_bytes)])

        body = BitWriter()
        for c in range(n_ch):
            _encode_subframe(body, block[:, c], 16)
        body.align()
        frame = hdr_bytes + body.bytes()
        frame += struct.pack(">H", _crc16(frame))
        out += frame
        frame_no += 1

    with open(path, "wb") as f:
        f.write(bytes(out))
