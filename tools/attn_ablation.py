#!/usr/bin/env python3
"""What holds the Hopper attention kernels back: ablation times on one GPU.

Builds variants of ``csrc/pflash.cu`` (B1), ``csrc/flash.cu`` (B5) and
``csrc/attn_f32.cu`` (their f32 instantiations), each with one piece of
work taken out of the committed sources by a textual substitution, and
times every variant through the port's own wrappers at the smoke shape of
``chip_smoke.py`` (8 x 12 heads x 1500 x 64; bf16 for B1/B5, f32 for
attn_f32), at its ragged lengths and at full lengths.  A variant's output
is wrong; only its time is read.  The time a variant saves against
``as-built`` is what that piece costs where nothing hides it.

  as-built          the committed sources
  no-exp            (bf16) ex2 returns its argument: no special-function work
  no-qk             (bf16) the S = Q K^T wgmma is not issued
  no-pv             (bf16) the O += P V wgmma is not issued
  always-rescale    (B1 bf16) O is rescaled on every tile, not only where a row's max grew
  one-tf32          (f32) one TF32 product a step in place of the 3 x TF32 split
  no-transform      (f32) the transform warps write neither K's small half nor V^T
  no-exp            (f32) the weights' expf is not taken (s - max is used as the weight)

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

# (library, variant) -> [(file, text, replacement)]; each text must occur in the sources
VARIANTS = {
    **{(lib, "as-built"): [] for lib in ("pflash", "flash", "attn_f32")},
    **{(lib, "no-exp"): [("attn_sm90.cuh", 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));', "y = x;")]
       for lib in ("pflash", "flash")},
    **{(lib, "no-qk"): [("attn_sm90.cuh", "    wgmma_ss<BK>(s, ", "    if (false) wgmma_ss<BK>(s, ")]
       for lib in ("pflash", "flash")},
    **{(lib, "no-pv"): [("attn_sm90.cuh", "    wgmma_rs<HD>(o, a[kk], ", "    if (false) wgmma_rs<HD>(o, a[kk], ")]
       for lib in ("pflash", "flash")},
    ("pflash", "always-rescale"): [("pflash.cu", "__any_sync(0xffffffffu, alpha0 != 1.f || alpha1 != 1.f)", "true")],
    ("attn_f32", "one-tf32"): [("attn_f32.cu", line, f"if (false) {line}") for line in (
        "wgmma_tf32_ss(s, q + off, ks + off, 1);", "wgmma_tf32_ss(s, qs + off, k + off, 1);",
        "wgmma_tf32_rs<HD>(o, big, vts + off, 1);", "wgmma_tf32_rs<HD>(o, small, vt + off, 1);")],
    ("attn_f32", "no-transform"): [
        ("attn_f32.cu", "        split_tile(sm, k_st, k_st + C::TILE, C::TILE, tw);\n", ""),
        ("attn_f32.cu", "      transpose_v<HD>(", "      if (false) transpose_v<HD>(")],
    ("attn_f32", "no-exp"): [("attn_f32.cu", "sc[j] = expf(sc[j] - ", "sc[j] = (sc[j] - ")],
}


def variant_sources(csrc: Path, root: Path, lib: str, name: str) -> Path:
    """Copy the kernel sources to ``root/lib/name`` with the variant's substitutions."""
    out = root / lib / name
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    for f in csrc.iterdir():
        shutil.copy(f, out / f.name)
    for f, old, new in VARIANTS[(lib, name)]:
        text = (out / f).read_text()
        if old not in text:
            raise RuntimeError(f"{lib}/{name}: {old!r} not found in {f}; the sources moved on")
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
    jobs = [(lib, v, variant_sources(_cuda.CSRC_DIR, root, lib, v)) for lib, v in VARIANTS]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        libs = list(pool.map(lambda j: _cuda.nvcc(j[2] / f"{j[0]}.cu", j[2] / f"lib{j[0]}.so",
                                                  j[2] / f"{j[0]}.log"), jobs))
    reports = {f"{lib}/{v}": chip_smoke.ptxas_report((d / f"{lib}.log").read_text()) for lib, v, d in jobs}

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    b, t, h, hd = 8, 1500, 12, 64
    d = h * hd
    ragged = torch.tensor([1500, 1500, 1211, 900, 640, 333, 17, 0], dtype=torch.int32, device=dev)
    full = torch.full_like(ragged, t)
    def wrappers(dtype):  # B1 and B5 on one packed projection of this dtype
        qkv = torch.randn(b, t, 3 * d, generator=gen).to(dtype).to(dev)
        qkv[..., :d] *= hd ** -0.5
        q, k, v = chip_smoke.head_views(qkv, h)
        return lambda n: fa.fused_qkv_attention(qkv, n, h), lambda n: fa.flash_attention(q, k, v, n)

    pflash, flash = wrappers(torch.bfloat16)
    pflash_f32, flash_f32 = wrappers(torch.float32)
    calls = {"pflash": {"pflash": pflash}, "flash": {"flash": flash},
             "attn_f32": {"pflash_f32": pflash_f32, "flash_f32": flash_f32}}
    results = {}
    with torch.no_grad():
        for (lib_name, variant, _), lib in zip(jobs, libs):
            _cuda._libraries[lib_name] = ctypes.CDLL(str(lib))
            for kernel, call in calls[lib_name].items():
                row = {lens: chip_smoke.time_ms(torch, lambda: call(n), args.iters)
                       for lens, n in (("ragged_ms", ragged), ("full_ms", full))}
                row["ptxas"] = reports[f"{lib_name}/{variant}"]
                results[f"{kernel}/{variant}"] = row
                print(f"[ablation] {kernel:10s} {variant:15s} ragged {row['ragged_ms']:.4f} ms, "
                      f"full {row['full_ms']:.4f} ms", flush=True)
        _cuda._libraries.clear()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"gpu": gpu, "shape": [b, h, t, hd], "results": results}, indent=1))
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
