#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``simwhisper_codec_tpu_torch``) on one GPU.

Phases, any failure exits non-zero:
  1. build the CUDA kernels of ``simwhisper_codec_tpu_torch/csrc`` (the
     five bf16/int8 sources and the f32 attention of ``attn_f32.cu``) with
     nvcc (sm_90a), one nvcc each, in parallel;
  2. hold each kernel against its plain PyTorch version at the main paths'
     shapes (batch 8; bf16, and f32 for the f32 attention kernels) and time
     kernel, plain version and, where one exists, a single PyTorch library
     call computing the same function (for B2 and B3, which no single call
     computes, the chain of library calls as ``library_chain_ms``, and each
     pass of B2, B3 and B4 alone as ``pass_ms``);
  3. run full-width random weights (config/SimWhisperCodec.yaml, fixed seed)
     through ``AudioCodec.encode`` + ``decode`` in parity, fast, fast-int8,
     fast with the flash attention core and the whole-block Vocos kernel
     (``attn_impl="flash", vocos_impl="fused-dw"``) and parity with the f32
     attention kernels (``attn_impl`` ``pflash`` and ``flash``), with launch
     counts read around each run, and those two kernels once more against
     their plain versions on the attention inputs of one 8 x 30 s batch of
     their run; the fast modes once more at "highest"
     precision (TF32 off) for comparison; one fast-int8 encode + decode on
     the pcm16 wire; then streaming sessions in fast-int8 against the batch
     calls;
  4. evaluate a small corpus (FLAC, WAV, MP3 where the system libraries
     exist, one corrupt file) through ``evaluate_corpus`` and the native
     loader; start the port's HTTP server twice (fast-int8; float32 and
     pcm16 wire) and send them requests, while the batch CLI
     (``python -m simwhisper_codec_tpu_torch.inference``) turns a FLAC and a
     WAV into reconstructions from a saved reference-layout checkpoint;
  5. print the kernel table, the GPU's name and power limit, and the result.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import argparse
import http.client
import json
import re
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, H100 SXM data sheet
H100_INT8_OPS = 1979e12
# f32-accurate products on the tensor cores take three TF32 products (a 3 x
# TF32 split) at the dense TF32 peak of 494.7 TFLOP/s
H100_F32_ACCURATE_FLOPS = 494.7e12 / 3
H100_BYTES_PER_S = 3.35e12
PEAK_NAMES = {H100_BF16_FLOPS: "989 TFLOP/s bf16 (H100 SXM, dense)",
              H100_INT8_OPS: "1979 TOP/s int8 (H100 SXM, dense)",
              H100_F32_ACCURATE_FLOPS: "494.7 TFLOP/s TF32 (H100 SXM, dense) / 3: f32-accurate work is 3 TF32 products"}
UTTERANCE_SECONDS = (4.0, 17.0, 41.0)  # 41 s crosses the 20 s chunk stride twice
# label -> AudioCodec arguments of each full-width run of phase 3
RUNS = {
    "parity": {"mode": "parity"},
    "fast": {"mode": "fast"},
    "fast-int8": {"mode": "fast-int8"},
    "fast-flash-dw": {"mode": "fast", "attn_impl": "flash", "vocos_impl": "fused-dw"},
    "parity-pflash": {"mode": "parity", "attn_impl": "pflash"},
    "parity-flash": {"mode": "parity", "attn_impl": "flash"},
}
STREAM_SECONDS = 47  # two strides and a tail


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def demangled_kernel(mangled: str) -> str:
    """``_ZN..._GLOBAL__N__<hash>18pflash_sm90_kernelILi64EEEv...`` -> ``pflash_sm90_kernel<64>``:
    the name is the suffix of the ``..._kernel`` run whose length the digits before it give."""
    run = re.search(r"(\w*?_kernel)I", mangled)
    if not run:
        return mangled
    chunk = run.group(1)
    name = next((chunk[k:] for k in range(1, len(chunk))
                 if chunk[k].isalpha() and chunk[:k].endswith(str(len(chunk) - k))), chunk)
    return f"{name}<{','.join(re.findall(r'Li(-?[0-9]+)E', mangled))}>"


def ptxas_report(log_text: str) -> dict:
    """Registers and spill bytes of each kernel in one nvcc build log (``-Xptxas -v``):
    {"pflash_sm90_kernel<64>": {"registers": 90, "spill_stores": 0, "spill_loads": 0}, ...}."""
    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = demangled_kernel(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def log_build_reports(build_dir: Path, names) -> None:
    """Print each kernel instantiation's registers and spill bytes from its
    build log, and every ptxas performance warning there (C7512 "wgmma ...
    serialized", C7508 "setmaxnreg ignored")."""
    for name in names:
        path = build_dir / f"{name}.log"
        text = path.read_text() if path.exists() else ""
        for fn, r in ptxas_report(text).items():
            log(f"[build] {name}.cu {fn}: {r.get('registers')} registers, "
                f"spill stores {r.get('spill_stores')} B, spill loads {r.get('spill_loads')} B")
        for line in text.splitlines():
            if re.search(r"C75\d\d", line):
                log(f"[build] {name}.cu warning: {line.strip()[:300]}")


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, peak: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(torch, name, got, want, atol, rtol=1.6e-2) -> float:
    """Raise unless the kernel's output is finite and |got - want| <= atol + rtol |want|
    everywhere; returns the max |got - want|."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    max_err = float(err.max())
    excess = float((err - (atol + rtol * want.float().abs())).max())
    finite = bool(torch.isfinite(got).all())
    log(f"[kernel] {name}: max_abs_err={max_err:.4g} mean_abs_err={float(err.mean()):.3g} "
        f"(tolerance |d| <= {atol} + {rtol}*|plain|), worst excess={excess:.4g}, finite={finite}")
    if not finite or excess > 0:
        raise AssertionError(f"{name} disagrees with its plain version")
    return max_err


def check_kernel(torch, name, kernel, plain, args, atol, rtol, flops, peak, nbytes, replaces, source,
                 library=None, iters=20, **extra_ms):
    """Compare and time one kernel; ``extra_ms`` names further calls timed for context."""
    max_err = compare(torch, name, kernel(*args), plain(*args), atol, rtol)
    ms = time_ms(torch, lambda: kernel(*args), iters)
    plain_ms = time_ms(torch, lambda: plain(*args), max(2, iters // 4))
    lib_ms = time_ms(torch, library, iters) if library is not None else None
    extra = {key: time_ms(torch, fn, iters) for key, fn in extra_ms.items()}
    b_ms, b_by = bound_ms(flops, peak, nbytes)
    log(f"[kernel] {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms}, {extra}, "
        f"bound {b_ms:.4f} ms ({b_by}), flops={flops:.4g}, bytes={nbytes:.4g}")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": 0,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_peak": PEAK_NAMES[peak], "library_ms": lib_ms, **extra}


def library_chain_bf16(torch, x, res, ln_w, ln_b, w1, b1, w2, b2, gamma, eps):
    """B2's function as five PyTorch calls (no single call computes the chain):
    a yardstick of the library's GEMMs, never on the port's path."""
    F = torch.nn.functional
    h = F.gelu(torch.addmm(b1, F.layer_norm(x, (x.shape[1],), ln_w, ln_b, eps), w1.t()), approximate="tanh")
    y = torch.addmm(b2, h, w2.t())
    return res + (y if gamma is None else gamma * y)


def library_chain_int8(torch, x, res, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, gamma, eps):
    """B3's function as PyTorch calls: row quantisation in torch ops and two
    ``torch._int_mm`` products with their rescales; a yardstick only."""
    F = torch.nn.functional

    def quant(v):
        s = v.abs().amax(-1, keepdim=True) / 127.0
        s = torch.where(s == 0, torch.ones_like(s), s)
        return torch.round(v / s).to(torch.int8), s

    xq, xs = quant(F.layer_norm(x.float(), (x.shape[1],), ln_w.float(), ln_b.float(), eps))
    h = F.gelu(torch._int_mm(xq, w1q.t()).float() * xs * s1 + b1.float(), approximate="tanh")
    hq, hs = quant(h)
    y = torch._int_mm(hq, w2q.t()).float() * hs * s2 + b2.float()
    return (res.float() + (y if gamma is None else gamma.float() * y)).to(x.dtype)


def pass_times(torch, timers: dict, name: str) -> dict:
    """Device time of each pass of a B2/B3 call alone (CUDA events), after
    one run of all passes in order to fill the shared workspaces."""
    for run in timers.values():
        run()
    out = {p: time_ms(torch, run, 10) for p, run in timers.items()}
    log(f"[kernel] {name} passes (ms): {json.dumps(out)}")
    return out


def random_block(torch, randn, c, inter):
    """A Vocos ConvNeXt block on the GPU with random weights of realistic scale."""
    from simwhisper_codec_tpu_torch.models.vocos import ConvNeXtBlock

    block = ConvNeXtBlock(c, inter, 1.0 / 24).to(randn(1).device)
    f32 = torch.float32
    with torch.no_grad():
        block.dwconv.weight.copy_(randn(c, 1, 7, scale=0.2, dtype=f32))
        block.dwconv.bias.copy_(randn(c, scale=0.02, dtype=f32))
        block.norm.weight.copy_(randn(c, scale=0.1, dtype=f32) + 1.0)
        block.norm.bias.copy_(randn(c, scale=0.1, dtype=f32))
        block.pwconv1.weight.copy_(randn(inter, c, scale=c ** -0.5, dtype=f32))
        block.pwconv1.bias.copy_(randn(inter, scale=0.02, dtype=f32))
        block.pwconv2.weight.copy_(randn(c, inter, scale=inter ** -0.5, dtype=f32))
        block.pwconv2.bias.copy_(randn(c, scale=0.02, dtype=f32))
        block.gamma.copy_(randn(c, scale=0.01, dtype=f32) + 1.0 / 24)
    return block


def head_views(qkv, heads: int):
    """(B, T, 3D) packed projections -> (B, H, T, hd) q, k, v views by stride,
    as ``varlen_attention_flash`` hands them to the B5 kernel."""
    d = qkv.shape[-1] // 3
    return [qkv[..., i * d:(i + 1) * d].unflatten(-1, (heads, d // heads)).transpose(1, 2) for i in range(3)]


def kernel_phase(torch):
    from simwhisper_codec_tpu_torch.ops import flash_attention as fa
    from simwhisper_codec_tpu_torch.ops import fused_convnext as fc
    from simwhisper_codec_tpu_torch.ops.quant import quantize_weight

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(1)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen) * scale).to(dtype).to(dev)

    rows = []
    # B1: encoder/decoder attention core, B = 8, T = 1500, 12 heads of 64
    b, t, h, hd = 8, 1500, 12, 64
    d = h * hd
    qkv = randn(b, t, 3 * d)
    qkv[..., :d] *= hd ** -0.5  # q arrives pre-scaled
    lengths = torch.tensor([1500, 1500, 1211, 900, 640, 333, 17, 0], dtype=torch.int32, device=dev)
    # Q K^T and P V over the keys a row attends (4 h t n hd); a length-0 row
    # averages all T values, which needs only P V (2 h t T hd)
    flops = sum(4.0 * h * t * n * hd if n > 0 else 2.0 * h * t * t * hd for n in lengths.tolist())
    nbytes = qkv.numel() * 2 + b * t * d * 2 + lengths.numel() * 4
    q, k, v = head_views(qkv, h)
    key_mask = (torch.arange(t, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    # the library yardstick: SDPA on the same (B, H, T, hd) views, boolean
    # key mask, no further scaling (q is pre-scaled).  At full lengths (the
    # codec's 8 x 30 s batch: every key valid) the same function is SDPA
    # with no mask, which takes its flash backend.
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=key_mask, scale=1.0)
    sdpa_full = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=1.0)
    full = torch.full_like(lengths, t)
    rows.append(check_kernel(torch, "pflash_attention", fa.fused_qkv_attention, fa.fused_qkv_attention_plain,
                             (qkv, lengths, h), 1e-2, 1.6e-2, flops, H100_BF16_FLOPS, nbytes,
                             "simwhisper_codec_tpu/ops/flash_attention.py:162", "simwhisper_codec_tpu_torch/csrc/pflash.cu",
                             library=sdpa, full_lengths_ms=lambda: fa.fused_qkv_attention(qkv, full, h),
                             library_full_ms=sdpa_full))
    # B5: the same work on (B, H, T, hd) views of the packed projections; its
    # bf16 weights are rounded after normalisation, so one bf16 output ulp
    # (atol 1e-2 + two half-ulps) bounds the kernel vs plain difference, as for B1
    rows.append(check_kernel(torch, "flash_attention", fa.flash_attention, fa.flash_attention_plain,
                             (q, k, v, lengths), 1e-2, 1.6e-2, flops, H100_BF16_FLOPS, nbytes,
                             "simwhisper_codec_tpu/ops/flash_attention.py:62", "simwhisper_codec_tpu_torch/csrc/flash.cu",
                             library=sdpa, full_lengths_ms=lambda: fa.flash_attention(q, k, v, full),
                             library_full_ms=sdpa_full))
    rows += attention_f32_rows(torch, randn, fa, (b, t, h, hd), lengths, flops)

    # Tolerances: bf16 outputs are compared as |d| <= atol + 1.6e-2 |plain|
    # (1.6e-2 is two bf16 half-ulps).  For int8 the atol is wider: LN sums in
    # another order can flip one activation's int8 rounding, which moves h by
    # one quantisation step times a weight and so flips a few per cent of
    # that row's second-stage roundings (measured worst case 0.0156 on the
    # H100 at the transformer shape).
    # B2 and B3 at the transformer FFN shape (residual = x, gamma = 1) and the
    # Vocos ConvNeXt shape (residual != x, gamma = layer scale).  The bound is
    # the fused function's; the h round trip of the pass design is not in it.
    for (m, c, inter, eps, vocos) in ((8 * 1500, 768, 3072, 1e-5, False), (8 * 3000, 512, 4096, 1e-6, True)):
        x = randn(m, c)
        res = randn(m, c) if vocos else x
        ln_w, ln_b = randn(c, scale=0.1) + 1.0, randn(c, scale=0.1)
        w1 = randn(inter, c, scale=c ** -0.5, dtype=torch.float32)
        w2 = randn(c, inter, scale=inter ** -0.5, dtype=torch.float32)
        b1, b2 = randn(inter, scale=0.02), randn(c, scale=0.02)
        gamma = randn(c, scale=0.01) + 1.0 / 24 if vocos else None
        w1b, w2b = w1.to(bf), w2.to(bf)
        act_bytes = (3 if vocos else 2) * m * c * 2
        ops = 4.0 * m * c * inter
        shape = f"{c}x{inter}"
        args = (x, res, ln_w, ln_b, w1b, b1, w2b, b2, gamma, eps)
        rows.append(check_kernel(torch, f"ln_ffn_bf16:{shape}", fc.fused_ln_ffn, fc.fused_ln_ffn_plain, args,
                                 1e-2, 1.6e-2, ops, H100_BF16_FLOPS, act_bytes + 2 * c * inter * 2 + (2 * c + inter) * 2,
                                 "simwhisper_codec_tpu/ops/fused_convnext.py:38",
                                 "simwhisper_codec_tpu_torch/csrc/ln_ffn.cu", iters=10,
                                 library_chain_ms=lambda: library_chain_bf16(torch, *args)))
        rows[-1]["pass_ms"] = pass_times(torch, fc.ffn_pass_timers("bf16", *args), rows[-1]["name"])
        w1q, s1 = quantize_weight(w1)
        w2q, s2 = quantize_weight(w2)
        args = (x, res, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, gamma, eps)
        rows.append(check_kernel(torch, f"ln_ffn_int8:{shape}", fc.fused_ln_ffn_int8, fc.fused_ln_ffn_int8_plain,
                                 args, 4e-2, 1.6e-2, ops, H100_INT8_OPS,
                                 act_bytes + 2 * c * inter + (inter + c) * 4 + (2 * c + inter) * 2,
                                 "simwhisper_codec_tpu/ops/fused_convnext.py:296",
                                 "simwhisper_codec_tpu_torch/csrc/ln_ffn_int8.cu", iters=10,
                                 library_chain_ms=lambda: library_chain_int8(torch, *args)))
        rows[-1]["pass_ms"] = pass_times(torch, fc.ffn_pass_timers("int8", *args), rows[-1]["name"])
    rows.append(check_convnext_dw(torch, randn, fc))
    check_other_shapes(torch, randn, fa, fc, quantize_weight)
    return rows


def attention_f32_rows(torch, randn, fa, shape, lengths, flops):
    """B1 and B5 on f32 inputs (parity mode with attn_impl "pflash" or
    "flash"), at the bf16 rows' shape and lengths.  The plain versions and
    the library run with TF32 off (``f32_precision("highest")``), and the
    kernels must agree to |d| <= 1e-5 + 1e-5 |plain|: f32 sums in another
    order, exact exp and division.  Library: SDPA on the same f32 views with
    the boolean key mask, and without a mask at full lengths."""
    from simwhisper_codec_tpu_torch.models.codec import f32_precision

    b, t, h, hd = shape
    d = h * hd
    qkv = randn(b, t, 3 * d, dtype=torch.float32)
    qkv[..., :d] *= hd ** -0.5
    q, k, v = head_views(qkv, h)
    dev = qkv.device
    key_mask = (torch.arange(t, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    full = torch.full_like(lengths, t)
    nbytes = qkv.numel() * 4 + b * t * d * 4 + lengths.numel() * 4
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=key_mask, scale=1.0)
    sdpa_full = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=1.0)
    rows = []
    with f32_precision("highest"):
        rows.append(check_kernel(torch, "pflash_attention_f32", fa.fused_qkv_attention, fa.fused_qkv_attention_plain,
                                 (qkv, lengths, h), 1e-5, 1e-5, flops, H100_F32_ACCURATE_FLOPS, nbytes,
                                 "simwhisper_codec_tpu/ops/flash_attention.py:162",
                                 "simwhisper_codec_tpu_torch/csrc/attn_f32.cu", library=sdpa, iters=10,
                                 full_lengths_ms=lambda: fa.fused_qkv_attention(qkv, full, h),
                                 library_full_ms=sdpa_full))
        rows.append(check_kernel(torch, "flash_attention_f32", fa.flash_attention, fa.flash_attention_plain,
                                 (q, k, v, lengths), 1e-5, 1e-5, flops, H100_F32_ACCURATE_FLOPS, nbytes,
                                 "simwhisper_codec_tpu/ops/flash_attention.py:62",
                                 "simwhisper_codec_tpu_torch/csrc/attn_f32.cu", library=sdpa, iters=10,
                                 full_lengths_ms=lambda: fa.flash_attention(q, k, v, full),
                                 library_full_ms=sdpa_full))
    full_flops = 4.0 * b * h * t * t * hd
    for row in rows:  # achieved rate of the 4 B H T kv hd operations (not counting the split's 3x)
        row["tflops"] = flops / row["ms"] / 1e9
        row["full_lengths_tflops"] = full_flops / row["full_lengths_ms"] / 1e9
        log(f"[kernel] {row['name']}: {row['tflops']:.2f} TFLOP/s, full lengths {row['full_lengths_tflops']:.2f}")
    return rows


def check_attention_f32_shapes(torch, randn, fa):
    """The f32 kernels at every head dim, B = 3, T = 203 (a ragged last
    tile), lengths 203, 77 and 0 (uniform average), q pre-scaled as the
    codec scales it; tolerance as at the main shape."""
    from simwhisper_codec_tpu_torch.models.codec import f32_precision

    lengths = torch.tensor([203, 77, 0], dtype=torch.int32, device=randn(1).device)
    with f32_precision("highest"):
        for hd in fa.HEAD_DIMS:
            qkv = randn(3, 203, 3 * 4 * hd, dtype=torch.float32)
            qkv[..., :4 * hd] *= hd ** -0.5
            args = (qkv, lengths, 4)
            compare(torch, f"pflash_attention_f32 hd={hd}", fa.fused_qkv_attention(*args),
                    fa.fused_qkv_attention_plain(*args), 1e-5, 1e-5)
            args = (*head_views(qkv, 4), lengths)
            compare(torch, f"flash_attention_f32 hd={hd}", fa.flash_attention(*args), fa.flash_attention_plain(*args),
                    1e-5, 1e-5)


def check_convnext_dw(torch, randn, fc):
    """B4: the whole Vocos ConvNeXt block at the Vocos shape, the virtual
    right edge inside the last tile; same bf16 tolerance as B2 (the f32
    depthwise sum and LN agree to f32 rounding, the rest is B2's chain).
    ``two_step_ms`` times plain depthwise shift-FMAs + B2 (the fused-vocos
    path), ``pass_ms`` each of B4's passes alone (rows / up / down), and
    ``bf16_weights_ms`` the call on a copy of the block whose weights are
    already bf16 (the codec keeps them f32, so each call casts W1 and W2)."""
    import copy

    from simwhisper_codec_tpu_torch.ops.conv import depthwise_conv1d_shifts

    dev, bf = randn(1).device, torch.bfloat16
    t4, c, inter = 3000, 512, 4096
    x4 = randn(8, t4, c)
    block = random_block(torch, randn, c, inter)
    fv = 2875
    block_bf16 = copy.deepcopy(block).to(bf)

    def two_step():
        mask = (torch.arange(t4, device=dev) < fv).to(bf)[None, :, None]
        xdw = depthwise_conv1d_shifts(x4 * mask, block.dwconv.weight[:, 0, :].t(), block.dwconv.bias, padding=3)
        return fc.fused_convnext_ffn(xdw.reshape(-1, c), x4.reshape(-1, c), block)

    m = 8 * t4
    row = check_kernel(torch, f"convnext_dw:{c}x{inter}", fc.fused_convnext_block_dw,
                       fc.fused_convnext_block_dw_plain, (x4, block, fv), 1e-2, 1.6e-2,
                       4.0 * m * c * inter + 14.0 * m * c, H100_BF16_FLOPS,
                       2 * m * c * 2 + 2 * c * inter * 2 + (7 * c + 5 * c + inter) * 2,
                       "simwhisper_codec_tpu/ops/fused_convnext.py:195",
                       "simwhisper_codec_tpu_torch/csrc/convnext_dw.cu", iters=10, two_step_ms=two_step,
                       bf16_weights_ms=lambda: fc.fused_convnext_block_dw(x4, block_bf16, fv))
    row["pass_ms"] = pass_times(torch, fc.ffn_pass_timers("dw", x4, block, fv), row["name"])
    return row


def check_convnext_dw_shapes(torch, randn, fc):
    """B4 against its plain version where the row kernel's window is at its
    edges: ragged T = 203 (six 32-row tiles and 11) with the edge at 150
    inside a tile, no valid row (frame_valid = 0: xdw is the bias), batch
    seams at B = 3 (a halo must not read the neighbouring item), T shorter
    than the 7-row window (1 and 5), and the widest C the wrapper takes."""
    cases = ((2, 203, 64, 128, (None, 150)), (2, 203, 256, 192, (None, 150)), (3, 203, 256, 192, (None, 150, 0)),
             (3, 1, 256, 192, (None, 0)), (3, 5, 256, 192, (None, 3)), (2, 203, 768, 256, (None, 150)))
    for b, t, c, inter, fvs in cases:
        x, block = randn(b, t, c), random_block(torch, randn, c, inter)
        for fv in fvs:
            compare(torch, f"convnext_dw:{c}x{inter} B={b} T={t} frame_valid={fv}",
                    fc.fused_convnext_block_dw(x, block, fv), fc.fused_convnext_block_dw_plain(x, block, fv), 1e-2)


def check_other_shapes(torch, randn, fa, fc, quantize_weight):
    """The kernels' other instantiations (head dims 16/32/128, narrow C, ragged
    M) against their plain versions at small shapes; no timing."""
    dev = randn(1).device
    agree = lambda name, got, want, atol: compare(torch, name, got, want, atol)
    lengths = torch.tensor([203, 77, 0], dtype=torch.int32, device=dev)
    for hd in (16, 32, 128):
        qkv = randn(3, 203, 3 * 4 * hd)
        args = (qkv, lengths, 4)
        agree(f"pflash_attention hd={hd}", fa.fused_qkv_attention(*args), fa.fused_qkv_attention_plain(*args), 1e-2)
        args = (*head_views(qkv, 4), lengths)
        agree(f"flash_attention hd={hd}", fa.flash_attention(*args), fa.flash_attention_plain(*args), 1e-2)
    check_attention_f32_shapes(torch, randn, fa)
    check_convnext_dw_shapes(torch, randn, fc)
    # ragged M (1 row; 127, one short of a block tile; 301), narrow C and I
    for m in (1, 127, 301):
        for c, inter in ((64, 128), (256, 192)):
            x, res = randn(m, c), randn(m, c)
            w1 = randn(inter * 2, c, scale=c ** -0.5, dtype=torch.float32)[:inter]
            w2 = randn(c, inter, scale=inter ** -0.5, dtype=torch.float32)
            vecs = (randn(c) + 1.0, randn(c, scale=0.1), randn(inter, scale=0.02), randn(c, scale=0.02), randn(c))
            args = (x, res, vecs[0], vecs[1], w1.to(torch.bfloat16), vecs[2], w2.to(torch.bfloat16), vecs[3], vecs[4],
                    1e-6)
            agree(f"ln_ffn_bf16:{c}x{inter} M={m}", fc.fused_ln_ffn(*args), fc.fused_ln_ffn_plain(*args), 1e-2)
            if inter % 64 == 0:
                (w1q, s1), (w2q, s2) = quantize_weight(w1.contiguous()), quantize_weight(w2)
                args = (x, res, vecs[0], vecs[1], w1q, s1, vecs[2], w2q, s2, vecs[3], vecs[4], 1e-6)
                agree(f"ln_ffn_int8:{c}x{inter} M={m}", fc.fused_ln_ffn_int8(*args),
                      fc.fused_ln_ffn_int8_plain(*args), 4e-2)


def expected_launches(label: str, cfg, n_tok: int, n_detok: int) -> dict:
    enc, dec, voc = cfg.acoustic_encoder, cfg.acoustic_decoder, cfg.vocos
    tshape = f"{enc.d_model}x{enc.encoder_ffn_dim}"
    vshape = f"{voc.dim}x{voc.intermediate_dim}"
    if label == "parity":
        return {}
    attn = n_tok * enc.encoder_layers + n_detok * dec.decoder_layers
    if label in ("parity-pflash", "parity-flash"):
        return {("pflash_attention_f32" if label == "parity-pflash" else "flash_attention_f32"): attn}
    if label == "fast-flash-dw":
        return {"flash_attention": attn, f"ln_ffn_bf16:{tshape}": attn,
                f"convnext_dw:{vshape}": n_detok * voc.num_layers}
    want = {"pflash_attention": attn}
    if label == "fast":
        want[f"ln_ffn_bf16:{tshape}"] = attn
        want[f"ln_ffn_bf16:{vshape}"] = n_detok * voc.num_layers
    else:
        want[f"ln_ffn_bf16:{tshape}"] = n_tok * enc.encoder_layers
        want[f"ln_ffn_int8:{tshape}"] = n_detok * dec.decoder_layers
        want[f"ln_ffn_int8:{vshape}"] = n_detok * voc.num_layers
    return want


def share_equal(a_list, b_list) -> float:
    return float(np.mean(np.concatenate([(a == b).ravel() for a, b in zip(a_list, b_list)])))


def codec_phase(torch, cfg, model):
    from simwhisper_codec_tpu_torch.models.codec import AudioCodec
    from simwhisper_codec_tpu_torch.ops import _cuda

    rng = np.random.default_rng(0)
    sr = cfg.input_sample_rate
    utts = [(rng.standard_normal(int(s * sr)) * 0.1).astype(np.float32) for s in UTTERANCE_SECONDS]
    batch = rng.standard_normal((8, cfg.chunk_samples)).astype(np.float32) * 0.1
    n_chunks = lambda n, stride: -(-n // stride)
    longest = max(len(u) for u in utts)
    n_tok = n_chunks(longest, (cfg.max_audio_seconds - 10) * sr)
    n_detok = n_chunks(longest // cfg.encoder_downsample_rate, (cfg.max_audio_seconds - 10) * sr // cfg.encoder_downsample_rate)

    results, codes_by_run, launches_by_run, codecs = {}, {}, {}, {}
    for label, kwargs in RUNS.items():
        codec = codecs[label] = AudioCodec(cfg, model, batch_size=8, device="cuda", **kwargs)
        codec.decode(codec.encode([utts[0][:sr]])["codes_list"])  # warm-up, not counted
        stage = stage_times(torch, codec, batch)
        # the path under test: chunked encode + decode of the utterances
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = codec.encode(utts)["codes_list"]
        dec = codec.decode(enc)["syn_wav_list"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_cuda.launch_counts)
        for u, c, y in zip(utts, enc, dec):
            n = len(u) // cfg.encoder_downsample_rate
            assert c.shape == (cfg.quantizer.num_groups, n), (label, c.shape)
            assert y.shape == (n * cfg.decoder_upsample_rate,), (label, y.shape)
            assert np.isfinite(y).all(), f"{label}: non-finite waveform"
        want = expected_launches(label, cfg, n_tok, n_detok)
        assert launches == want, f"{label}: launches {launches} != expected {want}"
        batch_rt = 8 * cfg.max_audio_seconds / ((stage["tokenize_ms"] + stage["detokenize_ms"]) / 1e3)
        results[label] = {"round_trip_x_real_time": sum(UTTERANCE_SECONDS) / wall, "wall_s": wall,
                          "batch8_x_real_time": batch_rt, **stage, "launches": launches}
        if label in F32_ATTENTION:
            results[label]["attention_max_abs_err"] = codec_attention_check(torch, codec, F32_ATTENTION[label], batch)
        codes_by_run[label] = enc
        launches_by_run[label] = launches
        log(f"[codec] {label}: {json.dumps(results[label])}")
    for a, b in zip(codes_by_run["fast-int8"], codes_by_run["fast"]):
        assert np.array_equal(a, b), "fast-int8 codes differ from fast codes"
    log(f"[codec] fast-int8 codes == fast codes; code agreement: fast vs parity "
        f"{share_equal(codes_by_run['fast'], codes_by_run['parity']):.4f}, fast-flash-dw vs fast "
        f"{share_equal(codes_by_run['fast-flash-dw'], codes_by_run['fast']):.4f}, parity-pflash vs parity "
        f"{share_equal(codes_by_run['parity-pflash'], codes_by_run['parity']):.4f}, parity-flash vs parity "
        f"{share_equal(codes_by_run['parity-flash'], codes_by_run['parity']):.4f} (report only)")
    for label in ("fast", "fast-int8"):
        precision_check(torch, codecs[label], label, batch, utts, codes_by_run[label])
    pcm16_check(torch, cfg, model, codecs["fast-int8"], utts)
    streaming_check(torch, cfg, codecs["fast-int8"])
    return launches_by_run, codecs["fast-int8"]


# parity runs with an f32 attention kernel -> the wrapper that launches it
F32_ATTENTION = {"parity-pflash": "fused_qkv_attention", "parity-flash": "flash_attention"}


def codec_attention_check(torch, codec, fn_name: str, batch) -> float:
    """The f32 attention kernel against its plain version on the codec's own
    inputs: every call of one tokenize + detokenize of the 8 x 30 s batch is
    recorded, then run through both, with the tolerance of phase 2.  Runs
    after the launch counts are read; returns the max |d| over all calls."""
    from simwhisper_codec_tpu_torch.models.codec import f32_precision
    from simwhisper_codec_tpu_torch.ops import flash_attention as fa

    kernel, plain = getattr(fa, fn_name), getattr(fa, f"{fn_name}_plain")
    calls = []

    def record(*args):
        calls.append(args)
        return kernel(*args)

    setattr(fa, fn_name, record)
    try:
        tok = codec.inference_tokenize(batch, np.full(len(batch), batch.shape[1]))
        codec.inference_detokenize(tok["codes"].cpu().numpy(), tok["codes_lengths"].cpu().numpy())
    finally:
        setattr(fa, fn_name, kernel)
    max_err, excess, finite = 0.0, -float("inf"), True
    with torch.no_grad(), f32_precision("highest"):
        for args in calls:
            got, want = kernel(*args), plain(*args)
            err = (got - want).abs()
            max_err = max(max_err, float(err.max()))
            excess = max(excess, float((err - (1e-5 + 1e-5 * want.abs())).max()))
            finite = finite and bool(torch.isfinite(got).all())
    log(f"[kernel] {fn_name} f32 at the codec's inputs ({len(calls)} calls): max_abs_err={max_err:.4g} "
        f"(tolerance |d| <= 1e-05 + 1e-05*|plain|), worst excess={excess:.4g}, finite={finite}")
    if not calls or not finite or excess > 0:
        raise AssertionError(f"{fn_name} (f32) disagrees with its plain version at the codec's inputs")
    return max_err


def stage_times(torch, codec, batch) -> dict:
    """Tokenize and detokenize ms of one full batch of 8 x 30 s (host clock
    around synchronised calls; the second of two repetitions)."""
    n = batch.shape[1]
    stage = {}
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok = codec.inference_tokenize(batch, np.full(len(batch), n))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        codec.inference_detokenize(tok["codes"].cpu().numpy(), tok["codes_lengths"].cpu().numpy())
        torch.cuda.synchronize()
        stage = {"tokenize_ms": (t1 - t0) * 1e3, "detokenize_ms": (time.perf_counter() - t1) * 1e3}
    return stage


def precision_check(torch, codec, label, batch, utts, codes_default) -> None:
    """The fast modes run at "default" precision (TF32 for the f32 mel DFT,
    FSQ and ISTFT).  The same codec at "default" and at "highest" (TF32
    off), timed in turns (default, highest, highest, default; stage ms the
    mean of each setting's two), and the code agreement of the two settings
    (report only)."""
    assert codec.precision == "default", (label, codec.precision)
    times = {"default": [], "highest": []}
    try:
        for setting in ("default", "highest", "highest", "default"):
            codec.precision = setting
            times[setting].append(stage_times(torch, codec, batch))
        codec.precision = "highest"
        codes = codec.encode(utts)["codes_list"]
    finally:
        codec.precision = "default"
    mean = {s: {k: float(np.mean([t[k] for t in ts])) for k in ts[0]} for s, ts in times.items()}
    log(f"[precision] {label}: " + "; ".join(
        f"{s} tokenize {m['tokenize_ms']:.2f} ms, detokenize {m['detokenize_ms']:.2f} ms" for s, m in mean.items())
        + f"; code agreement default vs highest {share_equal(codes_default, codes):.4f}")


def streaming_check(torch, cfg, codec):
    """fast-int8 streaming sessions at full width: a 47 s utterance fed in
    12345-sample blocks gives encode's codes exactly; its codes fed in
    37-frame blocks give decode's waveform within 1e-6."""
    from simwhisper_codec_tpu_torch.models.streaming import StreamingDecoder, StreamingEncoder

    wav = (np.random.default_rng(6).standard_normal(STREAM_SECONDS * cfg.input_sample_rate) * 0.1).astype(np.float32)
    t0 = time.perf_counter()
    codes = codec.encode([wav])["codes_list"][0]
    batch_wav = codec.decode([codes])["syn_wav_list"][0]
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc = StreamingEncoder(codec)
    parts = [out for i in range(0, len(wav), 12345) if (out := enc.feed(wav[i:i + 12345])) is not None]
    streamed = np.concatenate(parts + [t for t in [enc.flush()] if t is not None], axis=1)
    dec = StreamingDecoder(codec)
    waves = [out for i in range(0, codes.shape[1], 37) if (out := dec.feed(codes[:, i:i + 37])) is not None]
    streamed_wav = np.concatenate(waves + [t for t in [dec.flush()] if t is not None])
    stream_s = time.perf_counter() - t0
    assert streamed.shape == codes.shape and np.array_equal(streamed, codes), "streamed codes != encode's codes"
    err = float(np.abs(streamed_wav - batch_wav).max()) if streamed_wav.shape == batch_wav.shape else float("inf")
    log(f"[stream] fast-int8, {STREAM_SECONDS} s: codes {codes.shape} == encode's; waveform {streamed_wav.shape}, "
        f"max |streamed - decode| = {err:.3g} (atol 1e-6); {len(parts)} code strides and {len(waves)} waveform "
        f"strides before the flush; batch {batch_s:.3f} s, streamed {stream_s:.3f} s")
    assert err <= 1e-6, "streamed waveform != decode's waveform"


def pcm16_check(torch, cfg, model, codec_f32, utts):
    """fast-int8 on the pcm16 wire: codes equal the float wire's for input on
    the 16-bit grid, and the int16 waveforms equal the float ones quantised on
    the host.  cuDNN is held to deterministic algorithms so that the two
    codecs' runs can be compared bit for bit."""
    from simwhisper_codec_tpu_torch.models.codec import AudioCodec
    from simwhisper_codec_tpu_torch.utils.audio_io import to_pcm16

    codec_pcm = AudioCodec(cfg, model, batch_size=8, mode="fast-int8", device="cuda", wire="pcm16")
    grid = [to_pcm16(u).astype(np.float32) / 32768.0 for u in utts]
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        codes = codec_f32.encode(grid)["codes_list"]
        for a, b in zip(codes, codec_pcm.encode(grid)["codes_list"]):
            assert np.array_equal(a, b), "pcm16-wire codes differ from float-wire codes"
        y_f32 = codec_f32.decode(codes)["syn_wav_list"]
        y_pcm = codec_pcm.decode(codes)["syn_wav_list"]
    finally:
        torch.backends.cudnn.deterministic = prev
    for a, b in zip(y_f32, y_pcm):
        assert b.dtype == np.int16 and np.array_equal(b, to_pcm16(a)), "pcm16 decode != host-quantised float decode"
    log(f"[codec] pcm16 wire (fast-int8): codes == float-wire codes, int16 waveforms == host-quantised "
        f"float waveforms ({sum(len(y) for y in y_pcm)} samples)")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def request(port, method, path, body=None, headers=None, timeout=300):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def start_server(wire: str):
    port = free_port()
    proc = subprocess.Popen([sys.executable, "-m", "simwhisper_codec_tpu_torch.serve", "--port", str(port),
                             "--mode", "fast-int8", "--max_body_mb", "1", "--wire", wire])
    return proc, port


def wait_healthy(proc, port, deadline):
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"server exited with {proc.returncode}")
        try:
            status, _, _ = request(port, "GET", "/healthz", timeout=5)
            if status == 200:
                return
        except OSError:
            pass
        if time.time() > deadline:
            raise TimeoutError("server did not come up")
        time.sleep(1)


def serve_checks(port):
    wav = (np.random.default_rng(3).standard_normal(3 * 16000) * 0.1).astype(np.float32)
    status, hdr, body = request(port, "POST", "/encode", wav.tobytes())
    assert status == 200, (status, body[:200])
    shape = tuple(int(v) for v in hdr["X-Code-Shape"].split(","))
    assert shape == (8, len(wav) // 1280), shape
    codes = np.frombuffer(body, np.int32).reshape(shape)
    status, _, body = request(port, "POST", "/decode", codes.tobytes(), {"X-Code-Shape": f"{shape[0]},{shape[1]}"})
    out = np.frombuffer(body, np.float32)
    assert status == 200 and out.shape == (shape[1] * 1280,) and np.isfinite(out).all(), (status, out.shape)
    status, _, body = request(port, "POST", "/reconstruct", wav.tobytes())
    out2 = np.frombuffer(body, np.float32)
    assert status == 200 and out2.shape == out.shape and np.isfinite(out2).all(), (status, out2.shape)
    # a body over the 1 MiB cap is refused from its Content-Length alone,
    # so only the headers are sent (the server never reads the body)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.putrequest("POST", "/encode")
        conn.putheader("Content-Length", str(2 << 20))
        conn.endheaders()
        status = conn.getresponse().status
    finally:
        conn.close()
    assert status == 413, status
    status, _, body = request(port, "GET", "/healthz")
    health = json.loads(body)
    assert status == 200 and health["served"] >= 3, health
    log(f"[serve] /encode {shape}, /decode {out.shape}, /reconstruct {out2.shape}, 413 on a 2 MiB body, "
        f"/healthz {health}")


def serve_pcm16_check(port):
    wav = (np.random.default_rng(4).standard_normal(5 * 16000) * 0.1).astype(np.float32)
    status, _, body = request(port, "POST", "/reconstruct", wav.tobytes())
    out = np.frombuffer(body, np.float32)
    assert status == 200 and out.shape == (len(wav) // 1280 * 1280,) and np.isfinite(out).all(), (status, out.shape)
    assert np.array_equal(out * 32768.0, np.round(out * 32768.0)), "pcm16-wire output is off the 16-bit grid"
    log(f"[serve] --wire pcm16: /reconstruct {out.shape} on the 16-bit grid")


def write_inputs(torch, model, tmp: Path, sr: int) -> dict:
    """A reference-layout checkpoint of ``model`` and the CLI's two inputs:
    a FLAC (3 s) and a WAV (41 s)."""
    from simwhisper_codec_tpu_torch.utils.audio_io import save_audio
    from simwhisper_codec_tpu_torch.utils.flac import write_flac

    torch.save({"model": model.state_dict()}, tmp / "ckpt.pt")
    (tmp / "in").mkdir()
    rng = np.random.default_rng(5)
    lengths = {"short": 3 * sr, "long": 41 * sr}
    for stem, n in lengths.items():
        wav = (rng.standard_normal(n) * 0.1).astype(np.float32)
        if stem == "short":
            write_flac(tmp / "in" / f"{stem}.flac", np.round(wav * 32767).astype(np.int64), sr)
        else:
            save_audio(tmp / "in" / f"{stem}.wav", wav, sr)
    return lengths


def check_cli_outputs(tmp: Path, lengths: dict, sr: int) -> None:
    from simwhisper_codec_tpu_torch.utils.audio_io import load_audio

    names = sorted(p.name for p in (tmp / "out").iterdir())
    assert names == sorted(f"{stem}.wav" for stem in lengths), names
    for stem, n in lengths.items():
        y = load_audio(tmp / "out" / f"{stem}.wav", sr)
        assert y.shape == (n // 1280 * 1280,) and np.isfinite(y).all(), (stem, y.shape)
    log(f"[cli] python -m simwhisper_codec_tpu_torch.inference --mode fast: short.flac + long.wav -> {names}")


def corpus_phase(torch, cfg, codec):
    """``evaluate_corpus`` at full width in fast-int8, batch 8, on a
    temporary corpus: two FLAC files, two WAVs, one MP3 where the system
    libmpg123 and libmp3lame exist, and one corrupt file.  Every length is a
    multiple of 1280 samples, so the bitrate is bits_per_frame x 12.5 Hz."""
    from simwhisper_codec_tpu_torch.eval.corpus import evaluate_corpus
    from simwhisper_codec_tpu_torch.ops.fsq import bits_per_frame
    from simwhisper_codec_tpu_torch.utils import mp3, native_loader
    from simwhisper_codec_tpu_torch.utils.audio_io import save_audio
    from simwhisper_codec_tpu_torch.utils.flac import write_flac

    sr, rng = cfg.input_sample_rate, np.random.default_rng(7)
    wav = lambda n: (rng.standard_normal(n) * 0.1).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp_name:
        corpus, out = Path(tmp_name) / "corpus", Path(tmp_name) / "out"
        corpus.mkdir()
        for name, n in (("a.flac", 32 * 1280), ("b.flac", 80 * 1280)):
            write_flac(corpus / name, np.round(wav(n) * 32767).astype(np.int64), sr)
        save_audio(corpus / "c.wav", wav(64 * 1280), sr)
        save_audio(corpus / "d.wav", wav(416 * 1280), sr)  # 33.28 s: two chunks
        (corpus / "e.flac").write_bytes(b"fLaC" + bytes(12))
        files = 4
        if mp3.have_mpg123() and mp3.have_lame():
            mp3.write_mp3(corpus / "f.mp3", wav(48 * 1280), sr)
            files += 1
        else:
            log(f"mp3 not checked: no {'libmpg123' if not mp3.have_mpg123() else 'libmp3lame'}")
        before = dict(native_loader.loaded_files)
        stats = evaluate_corpus(codec, str(corpus), str(out), batch_size=8)
        log(f"[corpus] {json.dumps(stats)}")
        native = native_loader.loaded_files["native"] - before["native"]
        assert native_loader.available() and native == 4, f"native loader decoded {native} files, not 4"
        assert stats["files"] == files and stats["skipped"] == 1, stats
        want_bps = bits_per_frame(cfg.quantizer) * sr / cfg.encoder_downsample_rate
        assert abs(stats["bitrate_bps"] - want_bps) <= 0.05, (stats["bitrate_bps"], want_bps)
        written = sorted(p.name for p in out.iterdir())
        assert len(written) == files, written
    log(f"[corpus] native loader ({native_loader.library_path().name}) decoded the {native} FLAC and WAV files, "
        f"Python {native_loader.loaded_files['python'] - before['python']}; wrote {written}; bitrate "
        f"{stats['bitrate_bps']} bps = bits_per_frame x 12.5 Hz ({want_bps:.2f})")


def serve_and_cli_phase(torch, cfg, model):
    """Both servers and the CLI start at once (each pays its own start-up);
    the checks then run against each, and every process is stopped."""
    procs = []
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        lengths = write_inputs(torch, model, tmp, cfg.input_sample_rate)
        try:
            servers = {wire: start_server(wire) for wire in ("float32", "pcm16")}
            procs += [proc for proc, _ in servers.values()]
            cli = subprocess.Popen([sys.executable, "-m", "simwhisper_codec_tpu_torch.inference", "--mode", "fast",
                                    "--config_path", "config/SimWhisperCodec.yaml",
                                    "--checkpoint_path", str(tmp / "ckpt.pt"), "--input_dir", str(tmp / "in"),
                                    "--output_dir", str(tmp / "out")])
            procs.append(cli)
            deadline = time.time() + 300
            for proc, port in servers.values():
                wait_healthy(proc, port, deadline)
            serve_checks(servers["float32"][1])
            serve_pcm16_check(servers["pcm16"][1])
            if cli.wait(timeout=max(1.0, deadline - time.time())) != 0:
                raise RuntimeError(f"inference CLI exited with {cli.returncode}")
            check_cli_outputs(tmp, lengths, cfg.input_sample_rate)
        finally:
            for proc in procs:
                proc.terminate()
            for proc in procs:
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from simwhisper_codec_tpu_torch.config import load_config
    from simwhisper_codec_tpu_torch.models.codec import init_params
    from simwhisper_codec_tpu_torch.ops import _cuda

    log(f"[gpu] {gpu_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[build] {len(_cuda.SOURCES)} kernels built in {_cuda.build_kernels():.1f} s")
    log_build_reports(_cuda.BUILD_DIR, _cuda.SOURCES)
    with torch.no_grad():
        rows = kernel_phase(torch)
    cfg = load_config("config/SimWhisperCodec.yaml")
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator().manual_seed(0))
    log(f"[codec] full-width random weights: {sum(p.numel() for p in model.parameters())} parameters, "
        f"init {time.perf_counter() - t0:.1f} s")
    launches, serving_codec = codec_phase(torch, cfg, model)
    for row in rows:  # launches on the serving default's path, else on the first run that launched it
        row["launches"] = next((launches[r][row["name"]] for r in ("fast-int8", "fast", "fast-flash-dw",
                                                                  "parity-pflash", "parity-flash")
                                if launches[r].get(row["name"])), 0)
        row["launches_by_run"] = {r: launches[r].get(row["name"], 0) for r in launches}
    corpus_phase(torch, cfg, serving_codec)
    serve_and_cli_phase(torch, cfg, model)
    print(gpu_line())  # name and power limit, as nvidia-smi prints them
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
