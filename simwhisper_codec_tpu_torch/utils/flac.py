"""Self-contained FLAC codec (subset): numpy decoder and a minimal encoder.

The port's own copy of ``simwhisper_codec_tpu/utils/flac.py`` (numpy only,
so the port imports nothing of the JAX package).  The reference reads
``.flac`` corpora (LibriSpeech test-clean) through torchaudio
(``utils/helpers.py:77-93,105-111``); this decoder needs no optional
package.  The fast path is the C++ twin in ``native/audioloader.cpp``
(``utils/native_loader.py``); this module is the per-file path and the
encoder that writes test and smoke corpora.

Decoder coverage (the streamable subset that libFLAC encoders write):
 - metadata block walk, STREAMINFO parse, leading ID3v2 tags skipped
 - fixed and variable blocking, every block-size / sample-rate /
   sample-size header code, UTF-8 frame numbers
 - subframes: CONSTANT, VERBATIM, FIXED (orders 0-4), LPC (orders 1-32),
   wasted bits
 - Rice residual methods 0 (4-bit) and 1 (5-bit), escape partitions
 - stereo decorrelation: independent, left/side, right/side, mid/side
 - 8/16/24-bit samples -> float32 in [-1, 1)
 - frame-header CRC-8 and frame CRC-16 verification

Encoder: 16-bit mono or stereo, constant/verbatim/fixed (or LPC) subframes
chosen per block, Rice partitions, optional decorrelation, any block size.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

__all__ = ["decode_flac", "encode_flac", "read_flac", "write_flac", "FlacError",
           "probe_flac"]


class FlacError(ValueError):
    pass


# ---------------------------------------------------------------------------
# CRCs (frame header CRC-8 poly 0x07, frame CRC-16 poly 0x8005, init 0)
# ---------------------------------------------------------------------------

def _make_crc_table(poly: int, width: int) -> np.ndarray:
    table = np.zeros(256, np.uint32)
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    for i in range(256):
        c = i << (width - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) if (c & top) else (c << 1)
        table[i] = c & mask
    return table


_CRC8_TABLE = _make_crc_table(0x07, 8)
_CRC16_TABLE = _make_crc_table(0x8005, 16)


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = int(_CRC8_TABLE[(c ^ b) & 0xFF])
    return c


def crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = int(_CRC16_TABLE[((c >> 8) ^ b) & 0xFF]) ^ ((c << 8) & 0xFFFF)
    return c


# ---------------------------------------------------------------------------
# Bit readers / writers
# ---------------------------------------------------------------------------

class _BitReader:
    """MSB-first bit reader over a bytes object."""

    def __init__(self, data: bytes, pos_bytes: int = 0):
        self.data = data
        self.pos = pos_bytes * 8  # bit position

    def read(self, n: int) -> int:
        """Read n bits unsigned (n <= 57ish; frame fields are small)."""
        end = self.pos + n
        if end > len(self.data) * 8:
            raise FlacError("unexpected end of stream")
        out = 0
        pos = self.pos
        data = self.data
        while n > 0:
            byte = data[pos >> 3]
            avail = 8 - (pos & 7)
            take = min(avail, n)
            shift = avail - take
            out = (out << take) | ((byte >> shift) & ((1 << take) - 1))
            pos += take
            n -= take
        self.pos = pos
        return out

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def read_unary(self) -> int:
        """Count 0 bits until a 1 (the 1 is consumed)."""
        data = self.data
        pos = self.pos
        total_bits = len(data) * 8
        count = 0
        while True:
            if pos >= total_bits:
                raise FlacError("unexpected end of stream in unary")
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

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def byte_pos(self) -> int:
        return self.pos >> 3


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, n: int) -> None:
        if n == 0:
            return
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_signed(self, value: int, n: int) -> None:
        self.write(value & ((1 << n) - 1), n)

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self) -> None:
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def getvalue(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

_BLOCK_SIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                13: 8192, 14: 16384, 15: 32768}
_SAMPLE_RATES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
                 7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}
_SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

_FIXED_COEFFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _read_utf8_number(br: _BitReader) -> int:
    first = br.read(8)
    if first < 0x80:
        return first
    n_extra = 0
    mask = 0x40
    while first & mask:
        n_extra += 1
        mask >>= 1
    if n_extra == 0 or n_extra > 6:
        raise FlacError("bad UTF-8 coded number")
    value = first & (mask - 1)
    for _ in range(n_extra):
        b = br.read(8)
        if (b & 0xC0) != 0x80:
            raise FlacError("bad UTF-8 continuation")
        value = (value << 6) | (b & 0x3F)
    return value


def _decode_residual(br: _BitReader, block_size: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise FlacError(f"reserved residual method {method}")
    plen = 4 + method
    escape = (1 << plen) - 1
    part_order = br.read(4)
    n_parts = 1 << part_order
    if block_size % n_parts:
        raise FlacError("block size not divisible by partition count")
    part_samples = block_size >> part_order
    out = np.empty(block_size - order, np.int64)
    idx = 0
    for p in range(n_parts):
        count = part_samples - (order if p == 0 else 0)
        if count < 0:
            raise FlacError("partition underflow")
        param = br.read(plen)
        if param == escape:
            raw_bits = br.read(5)
            if raw_bits == 0:
                out[idx:idx + count] = 0
            else:
                for i in range(count):
                    out[idx + i] = br.read_signed(raw_bits)
        else:
            for i in range(count):
                q = br.read_unary()
                u = (q << param) | br.read(param) if param else q
                out[idx + i] = (u >> 1) ^ -(u & 1)
        idx += count
    return out


def _decode_subframe(br: _BitReader, block_size: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise FlacError("subframe padding bit set")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
        bps -= wasted
    if stype == 0:  # CONSTANT
        out = np.full(block_size, br.read_signed(bps), np.int64)
    elif stype == 1:  # VERBATIM
        out = np.array([br.read_signed(bps) for _ in range(block_size)], np.int64)
    elif 8 <= stype <= 12:  # FIXED order 0-4
        order = stype - 8
        out = np.empty(block_size, np.int64)
        for i in range(order):
            out[i] = br.read_signed(bps)
        res = _decode_residual(br, block_size, order)
        if order == 0:
            out[:] = res
        else:
            # order-k fixed prediction == k-fold integration of the residual,
            # seeded by the warmup samples' difference pyramid (vectorized)
            warmup = out[:order].copy()
            acc = res
            for k in range(order, 0, -1):
                seed = np.diff(warmup, k - 1)[-1] if k > 1 else warmup[-1]
                acc = seed + np.cumsum(acc)
            out[order:] = acc
    elif stype >= 32:  # LPC, order 1-32
        order = (stype & 0x1F) + 1
        out = np.empty(block_size, np.int64)
        for i in range(order):
            out[i] = br.read_signed(bps)
        prec = br.read(4) + 1
        if prec == 16:
            raise FlacError("invalid LPC precision")
        shift = br.read_signed(5)
        if shift < 0:
            raise FlacError("negative LPC shift")
        coeffs = [br.read_signed(prec) for _ in range(order)]
        res = _decode_residual(br, block_size, order)
        o = out
        for i in range(order, block_size):
            acc = 0
            for j in range(order):
                acc += coeffs[j] * int(o[i - 1 - j])
            o[i] = (acc >> shift) + res[i - order]
    else:
        raise FlacError(f"reserved subframe type {stype}")
    if wasted:
        out <<= wasted
    return out


def _decode_frame(data: bytes, pos: int, si_bps: int, si_rate: int,
                  verify_crc: bool = True) -> Tuple[np.ndarray, int, int]:
    """Returns (samples (channels, n), new_pos, sample_rate)."""
    br = _BitReader(data, pos)
    sync = br.read(14)
    if sync != 0x3FFE:
        raise FlacError(f"bad frame sync at byte {pos}")
    if br.read(1):
        raise FlacError("reserved bit set")
    br.read(1)  # blocking strategy (frame/sample number handled identically)
    bs_code = br.read(4)
    sr_code = br.read(4)
    ch_code = br.read(4)
    ss_code = br.read(3)
    if br.read(1):
        raise FlacError("reserved bit set")
    _read_utf8_number(br)

    if bs_code == 0:
        raise FlacError("reserved block size code")
    elif bs_code == 6:
        block_size = br.read(8) + 1
    elif bs_code == 7:
        block_size = br.read(16) + 1
    else:
        block_size = _BLOCK_SIZES[bs_code]

    sample_rate = si_rate
    if sr_code == 12:
        sample_rate = br.read(8) * 1000
    elif sr_code == 13:
        sample_rate = br.read(16)
    elif sr_code == 14:
        sample_rate = br.read(16) * 10
    elif sr_code == 15:
        raise FlacError("invalid sample rate code")
    elif sr_code:
        sample_rate = _SAMPLE_RATES[sr_code]

    bps = si_bps if ss_code == 0 else _SAMPLE_SIZES.get(ss_code)
    if bps is None:
        raise FlacError("reserved sample size code")

    header_end = br.byte_pos()
    header_crc = br.read(8)
    if verify_crc and crc8(data[pos:header_end]) != header_crc:
        raise FlacError("frame header CRC-8 mismatch")

    if ch_code < 8:
        n_ch = ch_code + 1
        chans = [_decode_subframe(br, block_size, bps) for _ in range(n_ch)]
    elif ch_code in (8, 9, 10):
        n_ch = 2
        # side channel carries +1 bit; it is subframe b except in
        # right/side mode (spec: left/side = L,S; right/side = S,R; mid/side = M,S)
        extra = (1, 0) if ch_code == 9 else (0, 1)
        a = _decode_subframe(br, block_size, bps + extra[0])
        b = _decode_subframe(br, block_size, bps + extra[1])
        if ch_code == 8:      # left/side
            chans = [a, a - b]
        elif ch_code == 9:    # right/side: left = side + right
            chans = [a + b, b]
        else:                 # mid/side
            side = b
            mid = (a << 1) | (side & 1)
            chans = [(mid + side) >> 1, (mid - side) >> 1]
    else:
        raise FlacError(f"reserved channel assignment {ch_code}")

    br.align()
    frame_end = br.byte_pos()
    frame_crc = int.from_bytes(data[frame_end:frame_end + 2], "big")
    if verify_crc and crc16(data[pos:frame_end]) != frame_crc:
        raise FlacError("frame CRC-16 mismatch")
    return np.stack(chans), frame_end + 2, sample_rate


def _parse_stream_header(data: bytes) -> Tuple[dict, int]:
    pos = 0
    # taggers commonly prepend ID3v2 tags to .flac files; skip them
    # (header: "ID3" ver(2) flags(1) syncsafe-size(4), then size bytes)
    while data[pos:pos + 3] == b"ID3" and len(data) >= pos + 10:
        size = ((data[pos + 6] & 0x7F) << 21) | ((data[pos + 7] & 0x7F) << 14) \
            | ((data[pos + 8] & 0x7F) << 7) | (data[pos + 9] & 0x7F)
        pos += 10 + size
    if data[pos:pos + 4] != b"fLaC":
        raise FlacError("not a FLAC stream (missing fLaC magic)")
    pos += 4
    info = None
    while True:
        if pos + 4 > len(data):
            raise FlacError("truncated metadata")
        hdr = data[pos]
        last = bool(hdr & 0x80)
        btype = hdr & 0x7F
        length = int.from_bytes(data[pos + 1:pos + 4], "big")
        body = data[pos + 4:pos + 4 + length]
        if btype == 0:
            if length < 34:
                raise FlacError("short STREAMINFO")
            br = _BitReader(body)
            br.read(16)  # min block
            br.read(16)  # max block
            br.read(24)  # min frame
            br.read(24)  # max frame
            rate = br.read(20)
            n_ch = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
            info = {"sample_rate": rate, "channels": n_ch, "bps": bps,
                    "total_samples": total}
        pos += 4 + length
        if last:
            break
    if info is None:
        raise FlacError("missing STREAMINFO")
    return info, pos


def probe_flac(path: str) -> dict:
    """STREAMINFO fields without decoding (for length bucketing)."""
    with open(path, "rb") as f:
        head = f.read(65536)
    info, _ = _parse_stream_header(head)
    return info


def decode_flac(data: bytes, verify_crc: bool = True) -> Tuple[np.ndarray, int]:
    """FLAC bytes -> (float32 samples (n, channels) in [-1, 1), sample_rate)."""
    info, pos = _parse_stream_header(data)
    bps, rate = info["bps"], info["sample_rate"]
    chunks: List[np.ndarray] = []
    decoded = 0
    while pos < len(data):
        # stop at STREAMINFO's sample count when it is known: real decoders
        # tolerate trailing junk (e.g. an appended ID3v1 'TAG' block) instead
        # of raising 'bad frame sync' on it
        if info["total_samples"] and decoded >= info["total_samples"]:
            break
        samples, pos, rate = _decode_frame(data, pos, bps, rate, verify_crc)
        chunks.append(samples)
        decoded += samples.shape[1]
    if not chunks:
        return np.zeros((0, info["channels"]), np.float32), rate
    pcm = np.concatenate(chunks, axis=1)  # (channels, n)
    total = info["total_samples"]
    if total and pcm.shape[1] > total:
        pcm = pcm[:, :total]
    scale = np.float32(1 << (bps - 1))
    return (pcm.T.astype(np.float32) / scale), rate


def read_flac(path: str, verify_crc: bool = True) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        return decode_flac(f.read(), verify_crc)


# ---------------------------------------------------------------------------
# Encoder (fixture generator; 16-bit)
# ---------------------------------------------------------------------------

def _rice_cost(res: np.ndarray, param: int) -> int:
    u = (np.abs(2 * res) - (res < 0)).astype(np.int64)
    return int(np.sum(u >> param)) + len(res) * (param + 1)


def _best_rice_param(res: np.ndarray) -> int:
    if len(res) == 0:
        return 0
    best, best_cost = 0, _rice_cost(res, 0)
    for p in range(1, 15):
        c = _rice_cost(res, p)
        if c < best_cost:
            best, best_cost = p, c
    return best


def _write_residual(bw: _BitWriter, res: np.ndarray, order: int,
                    block_size: int, partition_order: int = 0) -> None:
    bw.write(0, 2)  # method 0: 4-bit rice
    bw.write(partition_order, 4)
    n_parts = 1 << partition_order
    part_samples = block_size >> partition_order
    idx = 0
    for p in range(n_parts):
        count = part_samples - (order if p == 0 else 0)
        chunk = res[idx:idx + count]
        param = _best_rice_param(chunk)
        bw.write(param, 4)
        for v in chunk:
            u = int((v << 1) ^ (v >> 63))  # zigzag (v is int64)
            bw.write_unary(u >> param)
            if param:
                bw.write(u & ((1 << param) - 1), param)
        idx += count


def _lpc_analyze(x: np.ndarray, order: int, precision: int = 14):
    """Levinson-Durbin -> quantized integer LPC (coeffs, shift) or None."""
    xf = x.astype(np.float64)
    n = len(xf)
    if n <= order + 1:
        return None
    autoc = np.array([np.dot(xf[: n - k], xf[k:]) for k in range(order + 1)])
    if autoc[0] == 0:
        return None
    err = autoc[0]
    lpc = np.zeros(order)
    for i in range(order):
        acc = autoc[i + 1] - np.dot(lpc[:i], autoc[i:0:-1][:i])
        k = acc / err
        lpc[i] = k
        lpc[:i] = lpc[:i] - k * lpc[:i][::-1]
        err *= 1 - k * k
        if err <= 0:
            return None
    cmax = np.abs(lpc).max()
    if cmax == 0 or not np.isfinite(cmax):
        return None
    shift = precision - 1 - max(0, int(np.floor(np.log2(cmax))) + 1)
    shift = min(max(shift, 1), 15)
    q = np.round(lpc * (1 << shift)).astype(np.int64)
    limit = 1 << (precision - 1)
    q = np.clip(q, -limit, limit - 1)
    if np.all(q == 0):
        return None
    return q, shift


def _lpc_residual(x: np.ndarray, coeffs: np.ndarray, shift: int) -> np.ndarray:
    """Integer residual with the decoder's exact prediction arithmetic."""
    order = len(coeffs)
    n = len(x)
    # sum_j coeffs[j] * x[i-1-j] for i in [order, n)
    acc = np.zeros(n - order, np.int64)
    for j in range(order):
        acc += coeffs[j] * x[order - 1 - j: n - 1 - j]
    return x[order:] - (acc >> shift)


def _encode_subframe(bw: _BitWriter, x: np.ndarray, bps: int,
                     force_verbatim: bool = False, use_lpc: bool = False,
                     lpc_order: int = 8) -> None:
    x = x.astype(np.int64)
    n = len(x)
    if not force_verbatim and n and np.all(x == x[0]):
        bw.write(0, 1)
        bw.write(0, 6)   # CONSTANT
        bw.write(0, 1)
        bw.write_signed(int(x[0]), bps)
        return
    if use_lpc and not force_verbatim and n > lpc_order + 1:
        ana = _lpc_analyze(x, lpc_order)
        if ana is not None:
            coeffs, shift = ana
            precision = 14
            res = _lpc_residual(x, coeffs, shift)
            bw.write(0, 1)
            bw.write(0x20 | (lpc_order - 1), 6)  # LPC
            bw.write(0, 1)
            for i in range(lpc_order):
                bw.write_signed(int(x[i]), bps)
            bw.write(precision - 1, 4)
            bw.write_signed(shift, 5)
            for c in coeffs:
                bw.write_signed(int(c), precision)
            _write_residual(bw, res, lpc_order, n)
            return
    if not force_verbatim and n > 4:
        # pick the cheapest fixed order by residual sum-of-abs
        best_order, best_cost, best_res = 0, None, None
        series = x
        for order in range(5):
            res = series[order:].copy()
            for j, c in enumerate(_FIXED_COEFFS[order]):
                res = res - c * series[order - 1 - j:n - 1 - j]
            cost = int(np.sum(np.abs(res)))
            if best_cost is None or cost < best_cost:
                best_order, best_cost, best_res = order, cost, res
        bw.write(0, 1)
        bw.write(8 + best_order, 6)  # FIXED
        bw.write(0, 1)
        for i in range(best_order):
            bw.write_signed(int(x[i]), bps)
        _write_residual(bw, best_res, best_order, n,
                        partition_order=(2 if n % 4 == 0 and (n >> 2) > best_order else 0))
        return
    bw.write(0, 1)
    bw.write(1, 6)       # VERBATIM
    bw.write(0, 1)
    for v in x:
        bw.write_signed(int(v), bps)


def _write_utf8_number(bw: _BitWriter, value: int) -> None:
    """UTF-8-style coded number, any frame index (1-6 bytes; decoder twin:
    ``_read_utf8_number``)."""
    if value < 0x80:
        bw.write(value, 8)
        return
    n_extra = 1
    while value >= (1 << (6 - n_extra)) << (6 * n_extra):
        n_extra += 1
    lead_prefix = (0xFF << (7 - n_extra)) & 0xFF
    bw.write(lead_prefix | (value >> (6 * n_extra)), 8)
    for i in range(n_extra - 1, -1, -1):
        bw.write(0x80 | ((value >> (6 * i)) & 0x3F), 8)


def encode_flac(pcm: np.ndarray, sample_rate: int, block_size: int = 4096,
                bps: int = 16, stereo_mode: str = "independent",
                force_verbatim: bool = False, use_lpc: bool = False,
                lpc_order: int = 8) -> bytes:
    """int16-range int array (n,) or (n, channels) -> FLAC bytes.

    ``stereo_mode``: independent | left_side | right_side | mid_side.
    """
    if bps != 16:
        raise FlacError("encode_flac writes 16-bit streams only (the frame "
                        "header sample-size code is fixed to 16)")
    x = np.asarray(pcm)
    if x.dtype.kind == "f":
        x = np.clip(np.round(x * (1 << (bps - 1))), -(1 << (bps - 1)),
                    (1 << (bps - 1)) - 1)
    x = x.astype(np.int64)
    if x.ndim == 1:
        x = x[:, None]
    n, n_ch = x.shape
    if n_ch not in (1, 2) and stereo_mode != "independent":
        raise FlacError("decorrelation needs 2 channels")

    out = bytearray(b"fLaC")
    si = _BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sample_rate, 20)
    si.write(n_ch - 1, 3)
    si.write(bps - 1, 5)
    si.write(n, 36)
    body = si.getvalue() + b"\x00" * 16  # md5 unset (all zero = skip verify)
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    frame_no = 0
    for start in range(0, max(n, 1), block_size):
        blk = x[start:start + block_size]
        bsz = len(blk)
        if bsz == 0:
            break
        bw = _BitWriter()
        bw.write(0x3FFE, 14)
        bw.write(0, 1)
        bw.write(0, 1)  # fixed blocking
        bw.write(7, 4)  # block size: 16-bit field below
        bw.write(0, 4)  # sample rate: from STREAMINFO
        if n_ch == 2 and stereo_mode == "left_side":
            bw.write(8, 4)
        elif n_ch == 2 and stereo_mode == "right_side":
            bw.write(9, 4)
        elif n_ch == 2 and stereo_mode == "mid_side":
            bw.write(10, 4)
        else:
            bw.write(n_ch - 1, 4)
        bw.write(4, 3)  # 16-bit
        bw.write(0, 1)
        _write_utf8_number(bw, frame_no)
        bw.write(bsz - 1, 16)
        header = bw.buf.copy()
        assert bw.nbits == 0
        bw.write(crc8(bytes(header)), 8)

        if n_ch == 2 and stereo_mode != "independent":
            left, right = blk[:, 0], blk[:, 1]
            side = left - right
            if stereo_mode == "left_side":
                subs = [(left, bps), (side, bps + 1)]
            elif stereo_mode == "right_side":
                subs = [(side, bps + 1), (right, bps)]
            else:
                mid = (left + right) >> 1
                subs = [(mid, bps), (side, bps + 1)]
            for s, b in subs:
                _encode_subframe(bw, s, b, force_verbatim, use_lpc, lpc_order)
        else:
            for c in range(n_ch):
                _encode_subframe(bw, blk[:, c], bps, force_verbatim, use_lpc, lpc_order)
        bw.align()
        frame = bytes(bw.buf)
        out += frame + crc16(frame).to_bytes(2, "big")
        frame_no += 1
    return bytes(out)


def write_flac(path: str, pcm: np.ndarray, sample_rate: int, **kw) -> None:
    with open(path, "wb") as f:
        f.write(encode_flac(pcm, sample_rate, **kw))
