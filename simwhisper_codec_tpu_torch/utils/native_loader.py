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
   ``utils/audio_io.py``.

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
    lib.audioloader_load_batch.restype = ctypes.c_long
    lib.audioloader_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), ctypes.POINTER(ctypes.c_long),
    ]
    lib.audioloader_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
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
