#!/usr/bin/env python3
"""What holds the two Hopper attention kernels back: ablation times on one GPU.

Builds variants of ``csrc/pflash.cu`` (B1) and ``csrc/flash.cu`` (B5), each
with one piece of work taken out of the committed sources by a textual
substitution, and times every variant through the port's own wrappers at
the smoke shape of ``chip_smoke.py`` (8 x 12 heads x 1500 x 64), at its
ragged lengths and at full lengths.  A variant's output is wrong; only its
time is read.  The time a variant saves against ``as-built`` is what that
piece costs where nothing hides it.

  as-built        the committed sources
  no-exp          ex2 returns its argument: no special-function work
  no-qk           the S = Q K^T wgmma is not issued
  no-pv           the O += P V wgmma is not issued
  always-rescale  (B1) O is rescaled on every tile, not only where a row's max grew

Run from the repository root on the machine with the GPU:
    python3 tools/attn_ablation.py [--out chiprun_out/attn_ablation.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

# variant -> (file, text, replacement); each text must occur in the sources
VARIANTS = {
    "as-built": [],
    "no-exp": [("attn_sm90.cuh", 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));', "y = x;")],
    "no-qk": [("attn_sm90.cuh", "    wgmma_ss<BK>(s, ", "    if (false) wgmma_ss<BK>(s, ")],
    "no-pv": [("attn_sm90.cuh", "    wgmma_rs<HD>(o, a[kk], ", "    if (false) wgmma_rs<HD>(o, a[kk], ")],
    "always-rescale": [("pflash.cu", "__any_sync(0xffffffffu, alpha0 != 1.f || alpha1 != 1.f)", "true")],
}
KERNELS = ("pflash", "flash")


def variant_sources(csrc: Path, root: Path, name: str) -> Path:
    """Copy the attention sources to ``root/name`` with the variant's substitutions."""
    out = root / name
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    for f in ("attn_sm90.cuh", "common.cuh", "pflash.cu", "flash.cu"):
        shutil.copy(csrc / f, out / f)
    for f, old, new in VARIANTS[name]:
        text = (out / f).read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} not found in {f}; the sources moved on")
        (out / f).write_text(text.replace(old, new))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/attn_ablation.json")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("attn_ablation: no CUDA device", file=sys.stderr)
        return 2
    from simwhisper_codec_tpu_torch.ops import _cuda
    from simwhisper_codec_tpu_torch.ops import flash_attention as fa

    gpu = chip_smoke.gpu_line()
    print(f"[gpu] {gpu}; torch {torch.__version__}", flush=True)
    root = _cuda.BUILD_DIR / "ablation"
    jobs = [(v, k, variant_sources(_cuda.CSRC_DIR, root, v)) for v in VARIANTS for k in KERNELS]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        libs = list(pool.map(lambda j: _cuda.nvcc(j[2] / f"{j[1]}.cu", j[2] / f"lib{j[1]}.so",
                                                  j[2] / f"{j[1]}.log"), jobs))
    reports = {f"{v}/{k}": chip_smoke.ptxas_report((d / f"{k}.log").read_text()) for v, k, d in jobs}

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    b, t, h, hd = 8, 1500, 12, 64
    d = h * hd
    qkv = torch.randn(b, t, 3 * d, generator=gen).to(torch.bfloat16).to(dev)
    qkv[..., :d] *= hd ** -0.5
    q, k, v = chip_smoke.head_views(qkv, h)
    ragged = torch.tensor([1500, 1500, 1211, 900, 640, 333, 17, 0], dtype=torch.int32, device=dev)
    full = torch.full_like(ragged, t)
    calls = {"pflash": lambda n: fa.fused_qkv_attention(qkv, n, h), "flash": lambda n: fa.flash_attention(q, k, v, n)}
    results = {}
    with torch.no_grad():
        for (variant, kernel, _), lib in zip(jobs, libs):
            if kernel == "flash" and variant == "always-rescale":
                continue  # B5 has no rescale
            _cuda._libraries[kernel] = ctypes.CDLL(str(lib))
            row = {lens: chip_smoke.time_ms(torch, lambda: calls[kernel](n), args.iters)
                   for lens, n in (("ragged_ms", ragged), ("full_ms", full))}
            row["ptxas"] = reports[f"{variant}/{kernel}"]
            results[f"{kernel}/{variant}"] = row
            print(f"[ablation] {kernel:6s} {variant:15s} ragged {row['ragged_ms']:.4f} ms, "
                  f"full {row['full_ms']:.4f} ms, {row['ptxas'].get(f'{kernel}_sm90_kernel<64>')}", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"gpu": gpu, "shape": [b, h, t, hd], "results": results}, indent=1))
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
