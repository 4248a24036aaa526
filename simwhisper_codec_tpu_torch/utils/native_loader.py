"""ctypes bindings for the multithreaded C++ audio loader.

The port's own counterpart of ``simwhisper_codec_tpu/utils/native_loader.py``.
``native/audioloader.cpp`` (read in place) is built on first use with
``g++ -O3 -shared -fPIC -std=c++17 -lpthread`` into
``simwhisper_codec_tpu_torch/build/libaudioloader-<hash>.so``, named by a
hash of the source as ``ops/_cuda.py`` names the kernels, and exposes:

 - ``load_audio_batch(paths, target_sample_rate, num_threads, on_error)``:
   WAV and FLAC decoded by a native thread pool, with the sinc_interp_hann
   polyphase resampler, to mono float32; other formats (MP3), and files the
   library cannot read, take the per-file Python path of
   ``utils/audio_io.py``;
 - ``load_audio`` / ``save_audio``: one file, decoded by the library (WAV,
   FLAC) or written by it as 16-bit PCM WAV, else by ``utils/audio_io.py``.

Where no C++ compiler is found, every file takes the Python path (host
decoding either way; the log says once which loader is in use).
``loaded_files`` counts the files each path decoded.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from simwhisper_codec_tpu_torch.utils.audio_io import load_audio as py_load
from simwhisper_codec_tpu_torch.utils.audio_io import save_audio as py_save

logger = logging.getLogger(__name__)

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR.parent / "native" / "audioloader.cpp"
BUILD_DIR = PACKAGE_DIR / "build"
NATIVE_EXTENSIONS = (".wav", ".flac")

loaded_files: Dict[str, int] = {"native": 0, "python": 0}
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    return BUILD_DIR / f"libaudioloader-{hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]}.so"


def _build() -> Optional[ctypes.CDLL]:
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp), str(SOURCE), "-lpthread"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        except Exception as e:
            logger.warning("native audio loader not built (%s): every file takes the Python decoders", e)
            return None
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.audioloader_load.restype = ctypes.c_long
    lib.audioloader_load.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
    lib.audioloader_load_batch.restype = ctypes.c_long
    lib.audioloader_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), ctypes.POINTER(ctypes.c_long),
    ]
    lib.audioloader_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.audioloader_save_wav.restype = ctypes.c_int
    lib.audioloader_save_wav.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int]
    logger.info("native audio loader in use: %s", out)
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            _lib = _build()
    return _lib


def available() -> bool:
    return get_lib() is not None


def _count(path: str) -> None:
    with _lock:
        loaded_files[path] += 1


def load_audio(path: str, target_sample_rate: int = 16000) -> np.ndarray:
    """One file -> mono float32 at the target rate: WAV / FLAC through the
    library, anything else (or what it cannot read) through ``utils/audio_io.py``."""
    lib = get_lib()
    if lib is not None and str(path).lower().endswith(NATIVE_EXTENSIONS):
        out = ctypes.POINTER(ctypes.c_float)()
        n = lib.audioloader_load(str(path).encode(), target_sample_rate, ctypes.byref(out))
        if n >= 0:
            wav = np.ctypeslib.as_array(out, shape=(n,)).copy()
            lib.audioloader_free(out)
            _count("native")
            return wav
    wav = py_load(path, target_sample_rate)
    _count("python")
    return wav


def save_audio(path: str, wav: np.ndarray, sample_rate: int = 16000) -> None:
    """A 16-bit PCM mono WAV: float samples quantised by the library (x * 32768,
    clipped, truncated: ``to_pcm16``'s formula), else by ``utils/audio_io.py``,
    which also writes int16 input as it is."""
    lib = get_lib()
    wav = np.asarray(wav)
    if lib is not None and wav.dtype != np.int16:
        samples = np.ascontiguousarray(wav, np.float32).reshape(-1)
        ptr = samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if lib.audioloader_save_wav(str(path).encode(), ptr, len(samples), sample_rate) == 0:
            return
    py_save(path, wav, sample_rate)


def load_audio_batch(paths: List[str], target_sample_rate: int = 16000, num_threads: int = 0,
                     on_error: str = "raise") -> List[Optional[np.ndarray]]:
    """Decode many files, order-preserving: WAV/FLAC in the native thread
    pool, the rest (and what it cannot read) one by one in Python.
    ``on_error="none"`` gives ``None`` for a file that nothing decodes,
    instead of raising: the corpus evaluator's per-file skip (reference
    ``evaluate_model.py:128-141``)."""
    def py(p):
        try:
            wav = py_load(p, target_sample_rate)
        except Exception:
            if on_error == "raise":
                raise
            logger.warning("skipping undecodable file %s", p, exc_info=True)
            return None
        _count("python")
        return wav

    lib = get_lib()
    result: List[Optional[np.ndarray]] = [None] * len(paths)
    native_idx = [i for i, p in enumerate(paths) if str(p).lower().endswith(NATIVE_EXTENSIONS)] if lib else []
    if native_idx:
        n = len(native_idx)
        c_paths = (ctypes.c_char_p * n)(*[str(paths[i]).encode() for i in native_idx])
        outs = (ctypes.POINTER(ctypes.c_float) * n)()
        lens = (ctypes.c_long * n)()
        lib.audioloader_load_batch(c_paths, n, target_sample_rate, num_threads, outs, lens)
        for j, i in enumerate(native_idx):
            if lens[j] >= 0:
                result[i] = np.ctypeslib.as_array(outs[j], shape=(lens[j],)).copy()
                lib.audioloader_free(outs[j])
                _count("native")
            else:
                result[i] = py(paths[i])  # the Python decoders may still manage
    native_set = set(native_idx)
    for i, p in enumerate(paths):
        if i not in native_set:
            result[i] = py(p)
    return result
