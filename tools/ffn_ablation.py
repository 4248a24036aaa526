#!/usr/bin/env python3
"""Per-pass device times of the B2, B3 and B4 kernels at each block width.

At the main path's shapes (transformer FFN 768x3072 over 8 x 1500 rows,
Vocos 512x4096 over 8 x 3000 rows, random bf16 operands and int8 weights
from a fixed seed), times each pass of ``csrc/ln_ffn.cu`` and
``csrc/ln_ffn_int8.cu`` alone with CUDA events, and at the Vocos shape
those of ``csrc/convnext_dw.cu`` (kind ``dw``: its row kernel, then B2's
passes under B4's names), for each block width of the down pass
(``ops/fused_convnext.py::BLOCK_NS``; 128 runs two blocks an SM, 192 and 256
one; the up passes always run ``UP_BLOCK_N``); ``picked`` marks the width
``block_n`` picks.  Prints one JSON line per shape and kind; the table goes
to ``<out_dir>/ffn_ablation.json``.

Run from the repository root on the machine with the GPU:
    python3 tools/ffn_ablation.py [--out_dir profiles]
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHAPES = ((8 * 1500, 768, 3072, 1e-5, False), (8 * 3000, 512, 4096, 1e-6, True))


def time_ms(torch, fn, iters=10) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def operands(torch, m, c, inter, eps, vocos):
    from simwhisper_codec_tpu_torch.ops.quant import quantize_weight

    gen = torch.Generator().manual_seed(1)
    randn = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).cuda()
    bf = torch.bfloat16
    x = randn(m, c).to(bf)
    res = randn(m, c).to(bf) if vocos else x
    ln_w, ln_b = (randn(c, scale=0.1) + 1.0).to(bf), randn(c, scale=0.1).to(bf)
    w1, w2 = randn(inter, c, scale=c ** -0.5), randn(c, inter, scale=inter ** -0.5)
    b1, b2 = randn(inter, scale=0.02).to(bf), randn(c, scale=0.02).to(bf)
    gamma = (randn(c, scale=0.01) + 1.0 / 24).to(bf) if vocos else None
    (w1q, s1), (w2q, s2) = quantize_weight(w1), quantize_weight(w2)
    ops = {"bf16": (x, res, ln_w, ln_b, w1.to(bf), b1, w2.to(bf), b2, gamma, eps),
           "int8": (x, res, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, gamma, eps)}
    if vocos:  # B4 on x as (8, T, C): a ConvNeXt block with the same chain and random taps
        from simwhisper_codec_tpu_torch.models.vocos import ConvNeXtBlock

        block = ConvNeXtBlock(c, inter, 1.0 / 24).cuda()
        with torch.no_grad():
            block.dwconv.weight.copy_(randn(c, 1, 7, scale=0.2))
            block.dwconv.bias.copy_(randn(c, scale=0.02))
            for p, v in ((block.norm.weight, ln_w), (block.norm.bias, ln_b), (block.pwconv1.weight, w1),
                         (block.pwconv1.bias, b1), (block.pwconv2.weight, w2), (block.pwconv2.bias, b2),
                         (block.gamma, gamma)):
                p.copy_(v)
        ops["dw"] = (x.view(8, m // 8, c), block, m // 8 - 125, eps)
    return ops


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out_dir", default="profiles")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ffn_ablation: no CUDA device", file=sys.stderr)
        return 2
    from simwhisper_codec_tpu_torch.ops import _cuda
    from simwhisper_codec_tpu_torch.ops import fused_convnext as fc

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[gpu] {gpu}", flush=True)
    _cuda.build_kernels(["ln_ffn", "ln_ffn_int8", "convnext_dw"])
    table = []
    with torch.no_grad():
        for m, c, inter, eps, vocos in SHAPES:
            ops = operands(torch, m, c, inter, eps, vocos)
            picked = (fc.UP_BLOCK_N, fc.block_n(m, c))
            for kind, widths in itertools.product(ops, itertools.product((fc.UP_BLOCK_N,), fc.BLOCK_NS)):
                timers = fc.ffn_pass_timers(kind, *ops[kind], block_ns=widths)
                for run in timers.values():
                    run()
                row = {"gpu": gpu, "shape": f"{c}x{inter}", "m": m, "kind": kind, "up_bn": widths[0],
                       "down_bn": widths[1], "picked": widths == picked,
                       "pass_ms": {p: time_ms(torch, run) for p, run in timers.items()}}
                row["sum_ms"] = sum(row["pass_ms"].values())
                table.append(row)
                print(json.dumps(row), flush=True)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "ffn_ablation.json").write_text(json.dumps(table, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
