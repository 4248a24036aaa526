"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use with ``nvcc`` for ``sm_90a`` into its own shared library, then
loaded with ``ctypes``.  Nothing here runs at import time: this module
imports on machines without CUDA.

The libraries are the port's half of the JAX package's ``aot_dir``
(``utils/aot.py``): they are built into and loaded from ``build_dir()``,
which is the directory given to ``use_aot_dir`` (``AudioCodec(aot_dir=...)``,
``--aot_dir``), else ``$SIMWHISPER_AOT_DIR``, else
``simwhisper_codec_tpu_torch/build/``.  A library's name keys on a digest of
its source and every header, the ``nvcc --version`` line and the target
arch, so an edited source or another compiler builds anew and a later
process with the same key skips ``nvcc``.  A library that fails to load is
rebuilt once, with a warning.  Only the libraries persist: the CUDA graphs
that ``utils/aot.py`` captures live in the process, so a warm start skips
``nvcc``, not capture (``AudioCodec.trace_counts`` counts captures, where
the JAX package's count stays 0 on a warm start).

Every C entry point returns ``cudaGetLastError()`` after its launch;
``launch`` raises if that is not 0.  ``launch_counts`` holds one plain
integer per kernel call shape, incremented only where a wrapper launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import shutil
import subprocess
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

logger = logging.getLogger(__name__)

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"  # the default of build_dir()
SOURCES = ("pflash", "ln_ffn", "ln_ffn_int8", "flash", "convnext_dw", "attn_f32")
GENCODE = "arch=compute_90a,code=sm_90a"  # nvcc's target, part of a library's key
AOT_ENV = "SIMWHISPER_AOT_DIR"

# kernel name (with its call shape) -> launches since the last reset
launch_counts: Dict[str, int] = defaultdict(int)
_libraries: Dict[str, ctypes.CDLL] = {}
_aot_dir: Optional[Path] = None


def reset_launch_counts() -> None:
    launch_counts.clear()


def use_aot_dir(path) -> None:
    """Build and load the kernel libraries in ``path`` from now on (None:
    back to ``$SIMWHISPER_AOT_DIR`` or the default).  Libraries already
    loaded stay loaded: one with the same key is the same binary."""
    global _aot_dir
    _aot_dir = None if path is None else Path(path).expanduser()


def build_dir() -> Path:
    """Where the kernel libraries and their build logs are."""
    if _aot_dir is not None:
        return _aot_dir
    env = os.environ.get(AOT_ENV)
    return Path(env).expanduser() if env else BUILD_DIR


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine with the GPU")


@functools.lru_cache(maxsize=None)
def nvcc_version() -> str:
    """The last line of ``nvcc --version`` (the toolkit's release and build)."""
    out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def _library_path(name: str) -> Path:
    """build_dir() / lib<name>-<key>.so, the key a digest of the source, every
    header (any may be included), the compiler's version line and the target."""
    parts = [CSRC_DIR / f"{name}.cu"] + sorted(CSRC_DIR.glob("*.cuh"))
    blob = b"".join(p.read_bytes() for p in parts) + f"\n{nvcc_version()}\n{GENCODE}".encode()
    return build_dir() / f"lib{name}-{hashlib.sha1(blob).hexdigest()[:12]}.so"


def nvcc(source: Path, out: Path, log: Path) -> Path:
    """Compile one ``.cu`` (headers from its own directory) into the shared
    library ``out``; the compiler's output, with ptxas' register and spill
    report, goes to ``log``."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", GENCODE, "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(source.parent),
           "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log.write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def _compile(name: str, rebuild: bool = False) -> Path:
    out = _library_path(name)
    if out.exists() and not rebuild:
        return out
    return nvcc(CSRC_DIR / f"{name}.cu", out, out.parent / f"{name}.log")


def _load(name: str, path: Path) -> ctypes.CDLL:
    """Load a built library; one that fails to load (a truncated or foreign
    file under the same key) is rebuilt once, with a warning."""
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        logger.warning("kernel library %s does not load (%s); rebuilding it", path, e)
        return ctypes.CDLL(str(_compile(name, rebuild=True)))


def build_kernels(names: Optional[Iterable[str]] = None) -> float:
    """Compile the given (default: all) kernel sources in parallel, one nvcc
    each, into ``build_dir()``; returns the wall seconds taken.  Libraries
    already built under the same key are loaded without ``nvcc``."""
    names = list(names or SOURCES)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for name, path in zip(names, pool.map(_compile, names)):
            if name not in _libraries:
                _libraries[name] = _load(name, path)
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
    """The current CUDA stream of ``device``; any other device raises ValueError."""
    require(device.type == "cuda", f"unsupported device {device}")
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
