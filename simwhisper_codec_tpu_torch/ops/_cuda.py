"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use with ``nvcc`` for ``sm_90a`` into its own shared library under
``simwhisper_codec_tpu_torch/build/`` (named by a hash of the source, so an
edited source is rebuilt), then loaded with ``ctypes``.  Nothing here runs
at import time: this module imports on machines without CUDA.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``launch`` raises if that is not 0.  ``launch_counts`` holds one plain
integer per kernel call shape, incremented only where a wrapper launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
SOURCES = ("pflash", "ln_ffn", "ln_ffn_int8", "flash", "convnext_dw", "attn_f32")

# kernel name (with its call shape) -> launches since the last reset
launch_counts: Dict[str, int] = defaultdict(int)
_libraries: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    launch_counts.clear()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine with the GPU")


def _library_path(name: str) -> Path:
    parts = [CSRC_DIR / f"{name}.cu"] + sorted(CSRC_DIR.glob("*.cuh"))  # any header may be included
    digest = hashlib.sha1(b"".join(p.read_bytes() for p in parts)).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def nvcc(source: Path, out: Path, log: Path) -> Path:
    """Compile one ``.cu`` (headers from its own directory) into the shared
    library ``out``; the compiler's output, with ptxas' register and spill
    report, goes to ``log``."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(source.parent),
           "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log.write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def _compile(name: str) -> Path:
    out = _library_path(name)
    if out.exists():
        return out
    return nvcc(CSRC_DIR / f"{name}.cu", out, BUILD_DIR / f"{name}.log")


def build_kernels(names: Optional[Iterable[str]] = None) -> float:
    """Compile the given (default: all) kernel sources in parallel, one nvcc
    each; returns the wall seconds taken.  Already-built sources are reused."""
    names = list(names or SOURCES)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for name, path in zip(names, pool.map(_compile, names)):
            if name not in _libraries:
                _libraries[name] = ctypes.CDLL(str(path))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    if name not in _libraries:
        build_kernels([name])
    return _libraries[name]


c_int = ctypes.c_int
c_int64 = ctypes.c_longlong
c_float = ctypes.c_float


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """A tensor's device pointer; None is the null pointer (an absent operand)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch(lib_name: str, fn_name: str, count_key: Optional[str], *args) -> None:
    """Call ``fn_name`` of library ``lib_name`` (all arguments already ctypes
    values), raise on a non-zero CUDA error and count the launch under
    ``count_key`` (None: a call that a later, counted one completes)."""
    fn = getattr(library(lib_name), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = [type(a) for a in args]
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    if count_key is not None:
        launch_counts[count_key] += 1


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
