"""MP3 decode (and fixture encode) through the system codec libraries.

The port's own copy of ``simwhisper_codec_tpu/utils/mp3.py``: ctypes over
``libmpg123`` (decoder) and ``libmp3lame`` (encoder), no pip package.

 - :func:`read_mp3`: any MPEG-1/2/2.5 Layer I-III stream -> float32 PCM
   (mpg123 forced to 32-bit float output, no 16-bit requantisation);
 - :func:`probe_mp3`: sample count, rate and channels from a full-stream
   scan, without decoding (for corpus length bucketing);
 - :func:`write_mp3`: LAME CBR encode, for test fixtures and smoke corpora.

Every entry point raises ``RuntimeError`` when its library is missing;
callers gate on :func:`have_mpg123` / :func:`have_lame`.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional, Tuple

import numpy as np

# mpg123.h constants
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ENC_FLOAT_32 = 0x200

_mpg123: Optional[ctypes.CDLL] = None
_lame: Optional[ctypes.CDLL] = None


def _load(candidates) -> Optional[ctypes.CDLL]:
    for name in candidates:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


def _get_mpg123() -> Optional[ctypes.CDLL]:
    global _mpg123
    if _mpg123 is None:
        found = ctypes.util.find_library("mpg123")
        lib = _load(([found] if found else []) + ["libmpg123.so.0", "libmpg123.so"])
        if lib is not None:
            lib.mpg123_new.restype = ctypes.c_void_p
            lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
            lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.mpg123_getformat.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
            lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                          ctypes.c_int, ctypes.c_int]
            if hasattr(lib, "mpg123_format2"):
                lib.mpg123_format2.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                               ctypes.c_int, ctypes.c_int]
            lib.mpg123_rates.argtypes = [
                ctypes.POINTER(ctypes.POINTER(ctypes.c_long)),
                ctypes.POINTER(ctypes.c_size_t)]
            lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]
            lib.mpg123_scan.argtypes = [ctypes.c_void_p]
            lib.mpg123_length.argtypes = [ctypes.c_void_p]
            lib.mpg123_length.restype = ctypes.c_long
            lib.mpg123_close.argtypes = [ctypes.c_void_p]
            lib.mpg123_delete.argtypes = [ctypes.c_void_p]
            lib.mpg123_plain_strerror.restype = ctypes.c_char_p
            lib.mpg123_init()  # no-op on modern mpg123, required on old
            _mpg123 = lib
    return _mpg123


def _get_lame() -> Optional[ctypes.CDLL]:
    global _lame
    if _lame is None:
        found = ctypes.util.find_library("mp3lame")
        lib = _load(([found] if found else []) + ["libmp3lame.so.0", "libmp3lame.so"])
        if lib is not None:
            lib.lame_init.restype = ctypes.c_void_p
            for fn in ("lame_set_in_samplerate", "lame_set_num_channels",
                       "lame_set_brate", "lame_set_quality", "lame_init_params",
                       "lame_close"):
                getattr(lib, fn).argtypes = [ctypes.c_void_p] + (
                    [ctypes.c_int] if fn.startswith("lame_set") else [])
            lib.lame_encode_buffer_ieee_float.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_int]
            lib.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                              ctypes.c_int]
            if hasattr(lib, "lame_get_lametag_frame"):
                lib.lame_get_lametag_frame.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
                lib.lame_get_lametag_frame.restype = ctypes.c_size_t
            _lame = lib
    return _lame


def have_mpg123() -> bool:
    return _get_mpg123() is not None


def have_lame() -> bool:
    return _get_lame() is not None


def _err(lib, code: int, what: str) -> RuntimeError:
    msg = lib.mpg123_plain_strerror(code)
    return RuntimeError(f"mpg123 {what} failed: {msg.decode() if msg else code}")


def _force_float32(lib, h) -> None:
    """Restrict the handle to float32 output at any rate/channels.

    Must run BEFORE ``mpg123_open``: format restrictions only steer format
    negotiation, which happens when the first stream header is parsed —
    restricting afterwards leaves the already-negotiated s16 in effect.
    """
    lib.mpg123_format_none(h)
    mono_stereo = 1 | 2  # MPG123_MONO | MPG123_STEREO
    if hasattr(lib, "mpg123_format2"):
        code = lib.mpg123_format2(h, 0, mono_stereo, _MPG123_ENC_FLOAT_32)
        if code != _MPG123_OK:
            raise _err(lib, code, "format2")
        return
    rates = ctypes.POINTER(ctypes.c_long)()
    n = ctypes.c_size_t(0)
    lib.mpg123_rates(ctypes.byref(rates), ctypes.byref(n))
    for i in range(n.value):
        code = lib.mpg123_format(h, rates[i], mono_stereo, _MPG123_ENC_FLOAT_32)
        if code != _MPG123_OK:
            raise _err(lib, code, "format")


def _open_handle(lib, path: str):
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise _err(lib, err.value, "new")
    try:
        _force_float32(lib, h)
        if lib.mpg123_open(h, str(path).encode()) != _MPG123_OK:
            raise RuntimeError(f"mpg123 cannot open {path}")
    except Exception:
        lib.mpg123_delete(h)
        raise
    return h


def _query_format(lib, h) -> Tuple[int, int]:
    rate = ctypes.c_long(0)
    ch = ctypes.c_int(0)
    enc = ctypes.c_int(0)
    code = lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(ch), ctypes.byref(enc))
    if code != _MPG123_OK:
        raise _err(lib, code, "getformat")
    if enc.value != _MPG123_ENC_FLOAT_32:
        raise RuntimeError(f"mpg123 negotiated encoding {enc.value:#x}, not float32")
    return int(rate.value), int(ch.value)


def read_mp3(path: str) -> Tuple[np.ndarray, int]:
    """Decode an MP3 file -> (float32 PCM (n,) mono or (n, ch), sample_rate)."""
    lib = _get_mpg123()
    if lib is None:
        raise RuntimeError(f"cannot decode {path}: libmpg123 is unavailable")
    h = _open_handle(lib, path)  # float32 output forced pre-open
    try:
        rate, ch = _query_format(lib, h)
        chunks = []
        buf = ctypes.create_string_buffer(1 << 18)
        done = ctypes.c_size_t(0)
        while True:
            code = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(buf.raw[: done.value])
            if code == _MPG123_DONE:
                break
            if code == _MPG123_NEW_FORMAT:
                # format locked above; re-query to honor mid-stream changes
                rate, ch = _query_format(lib, h)
                continue
            if code != _MPG123_OK:
                raise _err(lib, code, "read")
        data = np.frombuffer(b"".join(chunks), dtype=np.float32)
        if ch > 1:
            data = data.reshape(-1, ch)
        return data, rate
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


def probe_mp3(path: str) -> Tuple[int, int, int]:
    """(samples_per_channel, sample_rate, channels) without PCM decode.

    Uses ``mpg123_scan`` for an exact length even on VBR streams with no
    Xing/Info header.
    """
    lib = _get_mpg123()
    if lib is None:
        raise RuntimeError(f"cannot probe {path}: libmpg123 is unavailable")
    h = _open_handle(lib, path)
    try:
        rate, ch = _query_format(lib, h)
        code = lib.mpg123_scan(h)
        if code != _MPG123_OK:
            raise _err(lib, code, "scan")
        n = int(lib.mpg123_length(h))
        if n < 0:
            raise RuntimeError(f"mpg123 cannot determine length of {path}")
        return n, rate, ch
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


def write_mp3(path: str, wav: np.ndarray, sample_rate: int,
              bitrate_kbps: int = 128) -> None:
    """CBR-encode float32 PCM (n,) or (n, ch<=2) to ``path`` via LAME."""
    lib = _get_lame()
    if lib is None:
        raise RuntimeError("cannot encode mp3: libmp3lame is unavailable")
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 1:
        left, right = wav, wav
        channels = 1
    elif wav.ndim == 2 and wav.shape[1] in (1, 2):
        left = np.ascontiguousarray(wav[:, 0])
        right = np.ascontiguousarray(wav[:, -1])
        channels = wav.shape[1]
    else:
        raise ValueError(f"expected (n,) or (n, 1|2) PCM, got {wav.shape}")
    n = len(left)

    gfp = lib.lame_init()
    if not gfp:
        raise RuntimeError("lame_init failed")
    try:
        lib.lame_set_in_samplerate(gfp, int(sample_rate))
        lib.lame_set_num_channels(gfp, channels)
        lib.lame_set_brate(gfp, int(bitrate_kbps))
        lib.lame_set_quality(gfp, 2)
        if lib.lame_init_params(gfp) < 0:
            raise RuntimeError("lame_init_params failed")
        out = ctypes.create_string_buffer(int(1.25 * n + 7200))
        left = np.ascontiguousarray(left)
        right = np.ascontiguousarray(right)
        nbytes = lib.lame_encode_buffer_ieee_float(
            gfp, left.ctypes.data_as(ctypes.c_void_p),
            right.ctypes.data_as(ctypes.c_void_p), n, out, len(out))
        if nbytes < 0:
            raise RuntimeError(f"lame_encode_buffer failed: {nbytes}")
        tail = ctypes.create_string_buffer(7200)
        ntail = lib.lame_encode_flush(gfp, tail, len(tail))
        with open(path, "wb") as f:
            f.write(out.raw[:nbytes])
            if ntail > 0:
                f.write(tail.raw[:ntail])
            # rewrite the first frame as a LAME/Xing tag so decoders trim the
            # codec delay + padding (gapless): mpg123 then yields exactly n
            # samples, matching the PCM that went in
            if hasattr(lib, "lame_get_lametag_frame"):
                tag = ctypes.create_string_buffer(8192)
                ntag = lib.lame_get_lametag_frame(gfp, tag, len(tag))
                if 0 < ntag <= len(tag):
                    f.seek(0)
                    f.write(tag.raw[:ntag])
    finally:
        lib.lame_close(gfp)
