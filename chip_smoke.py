#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``simwhisper_codec_tpu_torch``) on one GPU.

Phases, any failure exits non-zero:
  1. build the CUDA kernels of ``simwhisper_codec_tpu_torch/csrc`` (the
     five bf16/int8 sources and the f32 attention of ``attn_f32.cu``) with
     nvcc (sm_90a), one nvcc each, in parallel;
  2. hold each kernel against its plain PyTorch version at the main paths'
     shapes (batch 8; bf16, and f32 for the f32 attention kernels; B1, B2
     and B3 also at the bench's batch 16, compared only) and time
     kernel, plain version and, where one exists, a single PyTorch library
     call computing the same function (for B2 and B3, which no single call
     computes, the chain of library calls as ``library_chain_ms``, and each
     pass of B2, B3 and B4 alone as ``pass_ms``); then ``ffn_impl="int8"``,
     the JAX package's XLA int8 FFN (a library path, ``torch._int_mm``): its
     s32 products against the plain version's (equal) and the sublayer
     timed beside B2 and B3 at 768 x 3072 over 24000 rows;
  3. run full-width random weights (config/SimWhisperCodec.yaml, fixed seed)
     through ``AudioCodec.encode`` + ``decode`` in parity, fast, fast-int8,
     fast with the flash attention core and the whole-block Vocos kernel
     (``attn_impl="flash", vocos_impl="fused-dw"``) and parity with the f32
     attention kernels (``attn_impl`` ``pflash`` and ``flash``), with launch
     counts read around each run, and those two kernels once more against
     their plain versions on the attention inputs of one 8 x 30 s batch of
     their run (under ``utils.aot.eager()``); each run's tokenize and
     detokenize are CUDA graphs captured at its warm-up call and replayed
     after (``graph_check``: one program a direction, codes and waveforms
     against ``eager()`` (parity's bit for bit: its programs pin cuDNN's
     deterministic algorithms; ``determinism_check``: two eager parity round
     trips bit for bit, and the stage ms pinned against free), a held result
     unchanged by the next replay, the
     hand kernels traced in a replay as ``expected_launches`` counts them,
     graph and eager ms with the idle share, peak memory); the fast modes
     once more at "highest"
     precision (TF32 off) for comparison; one fast-int8 encode + decode on
     the pcm16 wire; then streaming sessions in fast-int8 against the batch
     calls;
  4. evaluate a small corpus (FLAC, WAV, MP3 where the system libraries
     exist, one corrupt file) through ``evaluate_corpus`` and the native
     loader; the quality evaluation (``eval_phase``): synthetic tower
     weights at the published widths, ``eval_corpus``'s full report on 8
     synthetic FLAC utterances through the serving codec (host metrics, code
     statistics, the HuBERT-large CTC, UTMOS and WavLM-large + ECAPA towers,
     each tower's ms per audio second and peak memory), each tower on the
     card against the CPU and bucket-padded against exact length, each
     tower's CUDA graph (``utils/aot.py``, one a bucket) against
     ``aot.eager()`` with its ms per audio second captured and eager
     (``tower_program_check``), the
     trainer's held-out probe; start the port's HTTP server twice
     (fast-int8; float32 and pcm16 wire) and send them requests, while the
     batch CLI (``python -m simwhisper_codec_tpu_torch.inference``) turns a
     FLAC and a WAV into reconstructions from a saved reference-layout
     checkpoint;
  5. train (no hand kernel runs there: the training path is dense f32),
     each run a child process with deterministic kernels, every step a CUDA
     graph captured after its warm-up step (``utils/aot.py``'s
     ``StepProgram``): full-width codec GAN steps through ``python -m
     simwhisper_codec_tpu_torch.experiments.codec.train`` (ms a step, audio
     seconds trained a GPU second, peak memory); ``--check train-graph``:
     full-width codec GAN steps and the recipe's three decayed epochs
     captured against ``aot.eager()``, bit for bit, with a load between
     (eager and replayed ms a step, warm-up and capture ms, peak memory of
     each); then, side by side, a fresh process resuming from a checkpoint
     bit for bit (capturing again after the load), the SIGKILL soak at
     --smoke width, one GAN step on the card against the CPU (eagerly), and
     the trainer (captured over NCCL) and ``AudioCodec(data_parallel=True)``
     under a world-size-1 NCCL group against runs without it (``--dp_gpus
     N`` runs only those over N GPUs);
  6. the variant modules and the HiFi-GAN continuation recipe
     (``variants_phase``): the encoder's hidden states at full width with the
     f32 B1 / B5 kernels against dense attention (launch counts read around
     each run) and each as a CUDA graph against eager, the recipe's two
     extractors' programs against eager (``extractor_program_check``), the
     semantic encoder, the Vocos variants, the STFT and the
     MDCT / IMDCT card against CPU; then, in child processes, the recipe at
     full width (data prep, Whisper-encoder features, 3 epochs of
     ``HifiGanConfig(768, 512)`` at batch 32 x 8960, the step captured at
     epoch 1 and replayed after, each epoch's rate 2e-4 * 0.9999^e in f32),
     a fresh process resuming from epoch 3's checkpoint with its state bit
     for bit (capturing again), and
     HuBERT-base feature extraction; the HiFi-GAN generator card against CPU;
  7. the tools (``tools_phase``): the FLOP ledger's FLOPs per audio second
     and MFU per mode (phase 3's batch times over the card's dense bf16
     peak); a ``torch.profiler`` trace of one fast-int8 tokenize +
     detokenize (``utils/profiling``) that must name its regions and the
     B1-B3 kernels; ``python -m simwhisper_codec_tpu_torch.tools.release_check
     --dry_run --corpus_n 8`` with phase 4's towers (must be ready); the
     drill's checkpoint loaded in process in its mode, on its files (launch
     counts, bitrate, reconstructions byte for byte, checksum report); the
     CLI twins (``evaluate_model``,
     ``calculate_wer``, ``spk_sim_cal``, ``extract_spk_emb``,
     ``calculate_utmos``) as children on the card against the drill's report;
     the drill's bench stage runs ``python -m simwhisper_codec_tpu_torch.bench``
     at its defaults (batch 16 x 30 s, 10 iterations) and its line must hold
     the JAX bench's 16 keys, finite rates, the int8 (mixed) headline,
     ``vs_baseline`` and MFU by their formulas, code agreement >= 0.85;
 7b. the bench in process (``bench_phase``): the
     bench's programs on the resident model against ``AudioCodec(mode,
     batch_size=16)`` for fast, fast-int8 (the mixed section) and
     fast-int8-full: codes equal, waveforms bit for bit (else within 1e-3 of
     max |y|), the launches of one round trip equal to serving's (launch runs
     ``bench-fast``, ``bench-fast-int8-mixed``, ``bench-fast-int8-full``), ten
     chained round trips that never synchronise and sum to ten times one;
     the bf16 section again with ``SIMWHISPER_FUSED_VOCOS=dw`` against
     ``AudioCodec(mode="fast", vocos_impl="fused-dw")`` (launch run
     ``bench-fast-dw``: B4 on every Vocos block) and ``bf16_x_realtime``
     with each Vocos;
     the serving codec's stage ms at batch 8 against the bench's programs
     on the batch already on the card (tokenize's input staging);
  8. tensor parallelism (``tp_phase``; ``parallel/mesh.py``): B1 / B5 on a
     rank's local heads (6 and 3 of 12) and the partial modes of B2, B3
     and B4 (each rank's f32 partial of its slice of I) against their plain
     versions at the model = 2 and 4 shapes (every rank's; tolerances
     sized to the partial's own max and mean |plain|), and every rank's
     partial summed against the unsharded function's f32 output before the
     residual; the one-process round trips of 8 x 30 s in parity, fast,
     fast-dw, fast-int8, parity with the f32 B1 / B5 and fast with the
     chunked and packed impls, then the same sharded over a model group of
     2, two processes sharing the card over gloo: launches a rank, parity's
     FSQ input and codes against one process, the fast modes' FSQ input
     within a one-process kernel swap's difference (``TP_SWAP_FACTOR``),
     each waveform (decoded from one process's codes) within the same
     bounds; then the training dry run's production geometry
     (``parallel/dryrun.py``) on that group.
     ``--tp_gpus N`` runs the TP part over N cards (NCCL; at 4: 1 x 2,
     1 x 4 and 2 x 2), where each rank's programs are also captured as CUDA
     graphs, as ``AudioCodec`` captures a model sharded over NCCL, and held
     against its eager run (``TP_CAPTURE_RUNS``);
  9. print the kernel table, the GPU's name and power limit, and the result.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import argparse
import contextlib
import http.client
import json
import os
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


def compare(torch, name, got, want, atol, rtol=1.6e-2, mean_rtol=None) -> float:
    """Raise unless the kernel's output is finite, |got - want| <= atol + rtol |want|
    everywhere and, with ``mean_rtol``, mean |got - want| <= mean_rtol mean |want|;
    returns the max |got - want|."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    excess = float((err - (atol + rtol * want.float().abs())).max())
    mean_bound = None if mean_rtol is None else mean_rtol * float(want.float().abs().mean())
    finite = bool(torch.isfinite(got).all())
    log(f"[kernel] {name}: max_abs_err={max_err:.4g} mean_abs_err={mean_err:.3g} "
        f"(tolerance |d| <= {atol:.4g} + {rtol}*|plain|, mean |d| <= {mean_bound}), worst excess={excess:.4g}, "
        f"finite={finite}")
    if not finite or excess > 0 or (mean_bound is not None and mean_err > mean_bound):
        raise AssertionError(f"{name} disagrees with its plain version")
    return max_err


# A partial-mode output (tensor parallelism) is one rank's f32 share of
# gamma (h W2^T + b2) with no residual, of any scale (gamma ~ 1/24 in the
# Vocos), so its tolerances follow its own size: max |d| <= PARTIAL_MAX_RTOL
# max |plain| and mean |d| <= PARTIAL_MEAN_RTOL mean |plain|.  Measured on
# the H100 (tools/tp_mutation_check.py): max |d| <= 0.46 % of max |plain|
# (rare bf16 / int8 rounding flips of h), mean |d| <= 2.8e-5 of mean
# |plain|; with b2 added on every rank the shards' sum is off by 2.0 % of
# its max and 3.0 % of its mean, with B3 quantising by a rank's own row
# max a partial by 1.8 % and 0.8 %.
PARTIAL_MAX_RTOL = 1e-2
PARTIAL_MEAN_RTOL = 1e-3


def partial_tol(torch, want) -> tuple:
    """(atol, rtol) of a partial-mode check on the plain output ``want``."""
    return PARTIAL_MAX_RTOL * float(want.float().abs().max()), 0.0


def check_kernel(torch, name, kernel, plain, args, atol, rtol, flops, peak, nbytes, replaces, source,
                 library=None, iters=20, mean_rtol=None, **extra_ms):
    """Compare and time one kernel; ``extra_ms`` names further calls timed for context."""
    max_err = compare(torch, name, kernel(*args), plain(*args), atol, rtol, mean_rtol)
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
    # B1 at the bench's batch (phase 7b: 16 x 30 s, full lengths), compared only
    qkv16 = randn(BENCH_BATCH, t, 3 * d)
    qkv16[..., :d] *= hd ** -0.5
    args = (qkv16, torch.full((BENCH_BATCH,), t, dtype=torch.int32, device=dev), h)
    rows[-1]["bench_batch_max_abs_err"] = compare(torch, f"pflash_attention B={BENCH_BATCH}",
                                                  fa.fused_qkv_attention(*args), fa.fused_qkv_attention_plain(*args),
                                                  1e-2, 1.6e-2)
    del qkv16, args
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
        rows[-1]["pass_ms"] = pass_times(torch, fc.ffn_passes("bf16", *args)[0], rows[-1]["name"])
        w1q, s1 = quantize_weight(w1)
        w2q, s2 = quantize_weight(w2)
        args = (x, res, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, gamma, eps)
        rows.append(check_kernel(torch, f"ln_ffn_int8:{shape}", fc.fused_ln_ffn_int8, fc.fused_ln_ffn_int8_plain,
                                 args, 4e-2, 1.6e-2, ops, H100_INT8_OPS,
                                 act_bytes + 2 * c * inter + (inter + c) * 4 + (2 * c + inter) * 2,
                                 "simwhisper_codec_tpu/ops/fused_convnext.py:296",
                                 "simwhisper_codec_tpu_torch/csrc/ln_ffn_int8.cu", iters=10,
                                 library_chain_ms=lambda: library_chain_int8(torch, *args)))
        rows[-1]["pass_ms"] = pass_times(torch, fc.ffn_passes("int8", *args)[0], rows[-1]["name"])
        # the same weights over the bench's rows (phase 7b, batch 16), compared only
        xb = randn(m * BENCH_BATCH // 8, c)
        resb = randn(*xb.shape) if vocos else xb
        for row, kernel, plain, weights, atol in (
                (rows[-2], fc.fused_ln_ffn, fc.fused_ln_ffn_plain, (w1b, b1, w2b, b2), 1e-2),
                (rows[-1], fc.fused_ln_ffn_int8, fc.fused_ln_ffn_int8_plain, (w1q, s1, b1, w2q, s2, b2), 4e-2)):
            args = (xb, resb, ln_w, ln_b, *weights, gamma, eps)
            row["bench_batch_max_abs_err"] = compare(torch, f"{row['name']} M={xb.shape[0]}", kernel(*args),
                                                     plain(*args), atol, 1.6e-2)
        del xb, resb, args
        torch.cuda.empty_cache()
    rows.append(check_convnext_dw(torch, randn, fc))
    check_dw_fold(torch, randn, fc, rows)
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
    fv = torch.full((), 2875, dtype=torch.int32, device=dev)  # the edge as the codec hands it: on the device
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
    row["pass_ms"] = pass_times(torch, fc.ffn_passes("dw", x4, block, fv)[0], row["name"])
    return row


def check_dw_fold(torch, randn, fc, rows) -> None:
    """The Vocos blocks' int8 (B3) and fused (B2) chains with the depthwise
    conv folded into the rows pass (``fused_convnext_block``) against the
    plain chain they replace (the edge-mask multiply and
    ``depthwise_conv1d_shifts``, then the unfolded kernel), bit for bit: the
    rows pass's workspaces (xq, xs and the cleared hmax; xn) and the block's
    output, at B x 3000 x 512 (B = 16, 8) with the edge at T, 1731, 1 and 0
    (a device int32, as the codec hands it).  At B = 8 and the edge at T the
    folded block and the chain are timed, and their rows passes (the folded
    one against the plain conv plus the unfolded one): ``folded_ms`` /
    ``chain_ms`` and ``folded_rows_ms`` / ``chain_rows_ms`` join the kernel
    table's 512 x 4096 rows."""
    from simwhisper_codec_tpu_torch.ops.conv import depthwise_conv1d_shifts
    from simwhisper_codec_tpu_torch.ops.quant import quantize_stacked_convnext

    dev = randn(1).device
    t, c, inter = 3000, 512, 4096
    block = random_block(torch, randn, c, inter)
    quantize_stacked_convnext([block])
    workspaces = {"int8": (12, 13, 14), "bf16": (10,)}
    table = {kind: next(r for r in rows if r["name"] == f"ln_ffn_{kind}:{c}x{inter}") for kind in workspaces}
    for b in (16, 8):
        x = randn(b, t, c)
        for fv in (t, 1731, 1, 0):
            width = torch.tensor(fv, dtype=torch.int32, device=dev)
            bound = fc.frame_bound(width, t, dev)

            def conv():
                mask = (torch.arange(t, device=dev) < width).to(x.dtype)[None, :, None]
                return depthwise_conv1d_shifts(x * mask, block.dwconv.weight[:, 0, :].t(), block.dwconv.bias,
                                               padding=3).reshape(-1, c)

            for impl, kind in (("int8", "int8"), ("fused", "bf16")):
                if kind == "int8":
                    weights = (block.pw1_q, block.pw1_s, block.pwconv1.bias, block.pw2_q, block.pw2_s,
                               block.pwconv2.bias)
                    chain_kernel = fc.fused_ln_ffn_int8
                else:
                    weights = (block.pwconv1.weight, block.pwconv1.bias, block.pwconv2.weight, block.pwconv2.bias)
                    chain_kernel = fc.fused_ln_ffn
                rest = (block.norm.weight, block.norm.bias, *weights, block.gamma, 1e-6)
                res = x.reshape(-1, c)
                plain_run, plain = fc.ffn_passes(kind, conv(), res, *rest)
                fold_run, fold = fc.ffn_passes(fc.FOLDED_KINDS[impl], x, block, bound)
                plain_run["rows"]()
                fold_run["rows"]()
                torch.cuda.synchronize()
                name = f"ln_ffn_{kind}:{c}x{inter} folded B={b} frame_valid={fv}"
                for i in workspaces[kind]:
                    if not torch.equal(plain[i].view(torch.uint8), fold[i].view(torch.uint8)):
                        raise AssertionError(f"{name}: the rows pass's workspace {i} differs from the plain chain's")
                chain = lambda: chain_kernel(conv(), res, *rest)
                folded = lambda: fc.fused_convnext_block(x, block, impl, bound)
                if not torch.equal(chain().view(x.shape).view(torch.int16), folded().view(torch.int16)):
                    raise AssertionError(f"{name}: the block's output differs from the plain chain's")
                log(f"[kernel] {name}: rows pass and output bit-equal to the plain chain's")
                if b == 8 and fv == t:
                    timed = {"folded_ms": time_ms(torch, folded, 10), "chain_ms": time_ms(torch, chain, 10),
                             "folded_rows_ms": time_ms(torch, fold_run["rows"], 20),
                             "chain_rows_ms": time_ms(torch, lambda: (conv(), plain_run["rows"]()), 10)}
                    log(f"[kernel] {name}: {json.dumps(timed)}")
                    table[kind].update(timed)
            del plain, fold, plain_run, fold_run
        del x
        torch.cuda.empty_cache()


def check_convnext_dw_shapes(torch, randn, fc):
    """B4 against its plain version where the row kernel's window is at its
    edges: ragged T = 203 (six 32-row tiles and 11) with the edge at 150
    inside a tile, no valid row (frame_valid = 0: xdw is the bias), batch
    seams at B = 3 (a halo must not read the neighbouring item), T shorter
    than the 7-row window (1 and 5), and the widest C the wrapper takes;
    each edge as an int and as a device int32 (as the codec hands it)."""
    cases = ((2, 203, 64, 128, (None, 150)), (2, 203, 256, 192, (None, 150)), (3, 203, 256, 192, (None, 150, 0)),
             (3, 1, 256, 192, (None, 0)), (3, 5, 256, 192, (None, 3)), (2, 203, 768, 256, (None, 150)))
    for b, t, c, inter, fvs in cases:
        x, block = randn(b, t, c), random_block(torch, randn, c, inter)
        for fv in fvs + tuple(torch.tensor(v, dtype=torch.int32, device=x.device) for v in fvs if v is not None):
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


def int8_ffn_check(torch) -> dict:
    """``ffn_impl="int8"``, the JAX package's XLA int8 FFN (a library path:
    ``ops/quant.py::int8_dynamic_matmul`` on ``torch._int_mm``, cuBLASLt; no
    hand kernel, so no row of the kernel table's JSON line): its two s32
    products at the transformer's shape (768 x 3072 over the bench's 24000
    rows) against the plain version's, which must be equal, and the whole
    FFN sublayer (``TransformerLayer.int8_ffn`` + the residual) timed beside
    B2 and B3 on the same rows, with the plain product timed in its place."""
    from simwhisper_codec_tpu_torch.config import EncoderConfig
    from simwhisper_codec_tpu_torch.models.transformer import TransformerLayer, init_transformer
    from simwhisper_codec_tpu_torch.ops import fused_convnext as fc
    from simwhisper_codec_tpu_torch.ops import quant

    enc = EncoderConfig()
    c, inter, m = enc.d_model, enc.encoder_ffn_dim, BENCH_BATCH * 1500  # the bench's encoder rows
    layer = TransformerLayer(c, enc.encoder_attention_heads, inter)
    init_transformer(layer, torch.Generator().manual_seed(2))
    layer = layer.cuda()
    quant.quantize_stacked_ffn([layer])
    x = (torch.randn(m, c, generator=torch.Generator().manual_seed(3))).to(torch.bfloat16).cuda()
    ln = layer.final_layer_norm
    xq, _ = quant.quantize_rows(x)
    hq = torch.randint(-127, 128, (m, inter), generator=torch.Generator().manual_seed(4), dtype=torch.int8).cuda()
    products = {"fc1": (xq, layer.fc1_q), "fc2": (hq, layer.fc2_q)}
    equal = {k: bool(torch.equal(quant.int8_product(a, w), quant.int8_product_plain(a, w)))
             for k, (a, w) in products.items()}

    def sublayer():
        return x + layer.int8_ffn(x).to(x.dtype)

    out = sublayer()
    saved = quant.int8_product
    quant.int8_product = quant.int8_product_plain  # the plain version: the float64 products on the card
    try:
        plain = sublayer()
        plain_ms = time_ms(torch, sublayer, 3)
    finally:
        quant.int8_product = saved
    ms = time_ms(torch, sublayer, 10)
    vecs = (ln.weight.to(torch.bfloat16), ln.bias.to(torch.bfloat16))
    b2_args = (x, x, *vecs, layer.fc1.weight.to(torch.bfloat16), layer.fc1.bias.to(torch.bfloat16),
               layer.fc2.weight.to(torch.bfloat16), layer.fc2.bias.to(torch.bfloat16), None, 1e-5)
    b3_args = (x, x, *vecs, layer.fc1_q, layer.fc1_s, layer.fc1.bias.to(torch.bfloat16), layer.fc2_q, layer.fc2_s,
               layer.fc2.bias.to(torch.bfloat16), None, 1e-5)
    b_ms, b_by = bound_ms(4.0 * m * c * inter, H100_INT8_OPS, 2 * m * c * 2 + 2 * c * inter + (inter + c) * 4)
    row = {"name": f"int8_dynamic_matmul ffn:{c}x{inter}", "route": "library (torch._int_mm, cuBLASLt)",
           "source": "simwhisper_codec_tpu_torch/ops/quant.py", "replaces": "simwhisper_codec_tpu/ops/quant.py:39",
           "rows": m, "s32_products_equal": equal, "max_abs_err": float((out.float() - plain.float()).abs().max()),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "b2_ms": time_ms(torch, lambda: fc.fused_ln_ffn(*b2_args), 10),
           "b3_ms": time_ms(torch, lambda: fc.fused_ln_ffn_int8(*b3_args), 10)}
    log(f"[kernel] {gpu_line()}: {json.dumps(row)}")
    assert all(equal.values()), f"torch._int_mm's s32 products differ from the plain version's: {equal}"
    assert bool(torch.isfinite(out).all()) and row["max_abs_err"] == 0.0, row
    return row


def expected_launches(label: str, cfg, n_tok: int, n_detok: int) -> dict:
    enc, dec, voc = cfg.acoustic_encoder, cfg.acoustic_decoder, cfg.vocos
    tshape = f"{enc.d_model}x{enc.encoder_ffn_dim}"
    vshape = f"{voc.dim}x{voc.intermediate_dim}"
    if label == "parity":
        return {}
    attn = n_tok * enc.encoder_layers + n_detok * dec.decoder_layers
    if label in ("parity-pflash", "parity-flash"):
        return {("pflash_attention_f32" if label == "parity-pflash" else "flash_attention_f32"): attn}
    if label in ("fast-flash-dw", "fast-dw"):  # B5 or B1, B2 in the transformers, B4 in the Vocos
        return {"flash_attention" if label == "fast-flash-dw" else "pflash_attention": attn,
                f"ln_ffn_bf16:{tshape}": attn, f"convnext_dw:{vshape}": n_detok * voc.num_layers}
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
    from simwhisper_codec_tpu_torch.utils import aot

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
        torch.cuda.reset_peak_memory_stats()
        codec = codecs[label] = AudioCodec(cfg, model, batch_size=8, device="cuda", **kwargs)
        # warm-up, not counted: captures the tokenize and detokenize graphs
        codec.decode(codec.encode([utts[0][:sr]])["codes_list"])
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
                          "batch8_x_real_time": batch_rt, **stage, "launches": launches,
                          "graphs": graph_check(torch, cfg, codec, label, batch, utts, enc, dec)}
        if label == "parity":
            results[label]["determinism"] = determinism_check(torch, codec, batch)
        if label in F32_ATTENTION:
            with aot.eager():  # it records the wrapper's Python calls, which a replay never makes
                results[label]["attention_max_abs_err"] = codec_attention_check(torch, codec, F32_ATTENTION[label],
                                                                                batch)
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
    return launches_by_run, codecs["fast-int8"], results


# parity runs with an f32 attention kernel -> the wrapper that launches it
F32_ATTENTION = {"parity-pflash": "fused_qkv_attention", "parity-flash": "flash_attention"}
# graph against eager waveforms where they are not bit for bit: max |d| <= RTOL * max |y|
GRAPH_WAVE_RTOL = {"parity": 1e-5, "bf16": 1e-3}


def profile_tool():
    """``tools/profile_torch_port.py`` (its kernel groups and ``trace_call``)."""
    tools = str(Path(__file__).resolve().parent / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import profile_torch_port

    return profile_torch_port


def replay_kernel_counts(torch, cfg, codec, label, batch) -> dict:
    """One replay of each program (tokenize + detokenize of the 8 x 30 s
    batch) under ``utils/profiling.trace``: each pass of each hand kernel
    appears in the trace as many times as ``expected_launches`` gives for one
    chunk each way, no other hand kernel appears, and the launch counts the
    replays add are the same.  Then one detokenize replay traced alone: its
    PyTorch elementwise kernels counted, and held to
    ``DETOKENIZE_ELEMENTWISE`` where the run has a count there.  Returns
    events by kernel group and that count."""
    from simwhisper_codec_tpu_torch.ops import _cuda
    from simwhisper_codec_tpu_torch.utils import profiling

    tool = profile_tool()
    lens = np.full(len(batch), batch.shape[1])
    tok = codec.inference_tokenize(batch, lens)
    codes, clen = tok["codes"].cpu().numpy(), tok["codes_lengths"].cpu().numpy()
    assert codec._tokenize.source == "replayed", codec._tokenize.source
    _cuda.reset_launch_counts()
    with tempfile.TemporaryDirectory() as logdir:
        with profiling.trace(logdir):
            codec.inference_tokenize(batch, lens)
            codec.inference_detokenize(codes, clen)
            torch.cuda.synchronize()
        assert codec._tokenize.source == codec._detokenize.source == "replayed"
        (trace_file,) = Path(logdir).glob("*.pt.trace.json")
        events = json.loads(trace_file.read_text())["traceEvents"]
    launches = dict(_cuda.launch_counts)
    want = expected_launches(label, cfg, 1, 1)
    assert launches == want, f"{label}: replayed launches {launches} != {want}"
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    want_events = {g: 0 for g, frags in tool.GROUPS.items() if g in tool.LAUNCH_GROUPS.values()}
    for key, n in want.items():
        want_events[tool.LAUNCH_GROUPS[key.split(":")[0]]] += n
    found = {}
    for group, n in want_events.items():
        for frag in tool.GROUPS[group]:
            found[frag.strip(":<")] = got = sum(frag in k for k in kernels)
            assert got == n, f"{label}: {got} traced {frag} kernels in the replays, expected {n}"
    with tempfile.TemporaryDirectory() as logdir:
        with profiling.trace(logdir):
            codec.inference_detokenize(codes, clen)
            torch.cuda.synchronize()
        (trace_file,) = Path(logdir).glob("*.pt.trace.json")
        events = json.loads(trace_file.read_text())["traceEvents"]
    elementwise = sum("elementwise" in e.get("name", "") for e in events if e.get("cat") == "kernel")
    want_elementwise = DETOKENIZE_ELEMENTWISE.get(label)
    assert want_elementwise in (None, elementwise), \
        f"{label}: {elementwise} elementwise kernels in a detokenize replay, expected {want_elementwise}"
    return {"kernel_events": found, "kernels_traced": len(kernels), "detokenize_elementwise": elementwise}


# PyTorch elementwise kernels in one detokenize replay.  The Vocos blocks'
# depthwise conv runs in the rows pass of B3 / B2: before that, as plain
# PyTorch (an edge-mask multiply, a pad, 7 tap multiplies, 7 adds a block),
# it put 1410 of them in a fast-int8 replay and 1482 in a fast one (H100).
DETOKENIZE_ELEMENTWISE = {"fast-int8": 1027, "fast": 1099}


def graph_check(torch, cfg, codec, label, batch, utts, enc, dec) -> dict:
    """The captured programs of one phase-3 run, after its encode + decode of
    the utterances (``enc``, ``dec``, from replays): one program per
    direction; the same calls under ``aot.eager()`` give the same codes and
    the same waveforms (bit for bit, else within ``GRAPH_WAVE_RTOL``); a
    result the caller holds is unchanged by a second, different call; each
    hand kernel traced in a replay as often as ``expected_launches`` says;
    graph and eager ms per stage with the device's idle share (the profile
    tool's ``trace_call``); peak memory with the graphs, and of an eager
    round trip."""
    from simwhisper_codec_tpu_torch.utils import aot

    assert codec.trace_counts == {"tokenize": 1, "detokenize": 1}, (label, codec.trace_counts)
    peak_graph = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with aot.eager():
        enc_eager = codec.encode(utts)["codes_list"]
        dec_eager = codec.decode(enc_eager)["syn_wav_list"]
    peak_eager = torch.cuda.max_memory_allocated()
    for a, b in zip(enc, enc_eager):
        assert np.array_equal(a, b), f"{label}: graph codes differ from eager codes"
    bits = all(np.array_equal(a, b) for a, b in zip(dec, dec_eager))
    wave_err = max(float(np.abs(a.astype(np.float64) - b).max()) for a, b in zip(dec, dec_eager))
    y_max = max(float(np.abs(b).max()) for b in dec_eager)
    rtol = GRAPH_WAVE_RTOL["parity" if label.startswith("parity") else "bf16"]
    assert bits or wave_err <= rtol * y_max, f"{label}: graph vs eager waveform {wave_err:.3g} > {rtol} x {y_max:.3g}"
    # parity pins cuDNN's deterministic algorithms (models/codec.py::mode_deterministic)
    assert bits or not label.startswith("parity"), f"{label}: graph vs eager waveform not bit for bit ({wave_err:.3g})"
    # a held result survives a second, different call of each program
    lens = np.full(len(batch), batch.shape[1])
    tok = codec.inference_tokenize(batch, lens)
    codes_np, clen_np = tok["codes"].cpu().numpy(), tok["codes_lengths"].cpu().numpy()
    held = dict(tok, **codec.inference_detokenize(codes_np, clen_np))
    held_host = {k: v.cpu() for k, v in held.items()}
    other = codec.inference_tokenize(batch[::-1] * 0.5, lens[::-1] // 2)
    other.update(codec.inference_detokenize(other["codes"].cpu().numpy(), other["codes_lengths"].cpu().numpy()))
    assert not torch.equal(other["y"].cpu(), held_host["y"]), f"{label}: the second call is not a different one"
    changed = [k for k, v in held.items() if not torch.equal(v.cpu(), held_host[k])]
    assert not changed, f"{label}: held results {changed} changed under the next replay"
    assert codec.trace_counts == {"tokenize": 1, "detokenize": 1}, (label, codec.trace_counts)
    tool = profile_tool()
    stages = {"tokenize": lambda: codec.inference_tokenize(batch, lens),
              "detokenize": lambda: codec.inference_detokenize(codes_np, clen_np)}
    timing = {}
    for program in ("graph", "eager", "eager", "graph"):  # in turns; each stage's second reading is kept
        with aot.eager() if program == "eager" else contextlib.nullcontext():
            timing[program] = {stage: {k: r[k] for k in ("wall_ms", "traced_wall_ms", "device_ms", "idle_share")}
                               for stage, fn in stages.items() for r in [tool.trace_call(torch, fn)]}
    out = {"trace_counts": codec.trace_counts, "codes_equal_eager": True, "waveform_bit_for_bit": bits,
           "waveform_max_abs_diff": wave_err, "held_result_unchanged": True, **timing,
           "peak_allocated_bytes": {"graph_run": peak_graph, "eager_round_trip": peak_eager},
           **replay_kernel_counts(torch, cfg, codec, label, batch)}
    log(f"[graph] {label}: {json.dumps(out)}")
    return out


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


def determinism_check(torch, codec, batch) -> dict:
    """Parity's programs pin cuDNN's deterministic algorithms: two eager
    round trips of the 8 x 30 s batch give the same codes and waveforms bit
    for bit; the same two with the caller's flag instead (cuDNN free to pick
    its algorithms, as parity ran before) are reported; tokenize and
    detokenize ms through the graphs with each setting, in turns (pinned,
    free, free, pinned; each the mean of its two)."""
    from simwhisper_codec_tpu_torch.utils import aot

    lens = np.full(len(batch), batch.shape[1])

    def round_trip():
        tok = codec.inference_tokenize(batch, lens)
        y = codec.inference_detokenize(tok["codes"].cpu().numpy(), tok["codes_lengths"].cpu().numpy())["y"]
        return tok["codes"].cpu().numpy(), y.cpu().numpy()

    pinned = codec.deterministic
    assert pinned is True, codec.deterministic
    out, times = {}, {"pinned": [], "free": []}
    try:
        for setting, flag in (("pinned", True), ("free", None)):
            codec.deterministic = flag
            with aot.eager():
                (c1, y1), (c2, y2) = round_trip(), round_trip()
            out[setting] = {"codes_equal": bool(np.array_equal(c1, c2)), "waveform_bit_for_bit": bool(
                np.array_equal(y1, y2)), "waveform_max_abs_diff": float(np.abs(y1.astype(np.float64) - y2).max())}
        for setting in ("pinned", "free", "free", "pinned"):
            codec.deterministic = True if setting == "pinned" else None
            times[setting].append(stage_times(torch, codec, batch))
    finally:
        codec.deterministic = pinned
    for setting, ts in times.items():
        out[setting].update({k: float(np.mean([t[k] for t in ts])) for k in ts[0]})
    log(f"[determinism] {gpu_line()}: parity, two eager round trips of 8 x 30 s and stage ms through the graphs "
        f"(host clock, synchronised), cuDNN deterministic pinned vs the caller's flag (False): {json.dumps(out)}")
    assert out["pinned"]["codes_equal"] and out["pinned"]["waveform_bit_for_bit"], out["pinned"]
    return out


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


EVAL_FILES, EVAL_SECONDS = 8, (4.0, 8.0)
TOWER_TOL = 1e-4  # card vs CPU, and padded vs exact length: max |d| <= TOL * max(max |ref|, 1)


def tower_err(got, want) -> float:
    """max |got - want| over max(max |want|, 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(float(np.max(np.abs(want))), 1.0))


def tower_outputs(torch, weights: Path, device: str, wav: np.ndarray) -> dict:
    """Each full-width tower once on ``device`` (TF32 off): the CTC logits of
    the valid frames and the transcript, the UTMOS score, the speaker
    embedding; each padded to its power-of-two-second bucket."""
    from simwhisper_codec_tpu_torch.eval.speaker import SpeakerEmbedder
    from simwhisper_codec_tpu_torch.eval.utmos import UTMOSScorer
    from simwhisper_codec_tpu_torch.eval.wer import CTCTranscriber

    asr = CTCTranscriber(str(weights / "hubert_ctc"), device=device)
    logits = asr.logits(wav).cpu().numpy()
    out = {"ctc_logits": logits, "transcript": asr.transcribe(wav), "asr": asr}
    out["utmos"] = UTMOSScorer(str(weights / "utmos22_strong.ckpt"), device=device)
    out["utmos_score"] = out["utmos"].score(wav)
    out["speaker"] = SpeakerEmbedder.from_checkpoint(str(weights / "wavlm_large_finetune.pth"), device=device)
    out["embedding"] = out["speaker"].embed(wav)
    return out


def padded_vs_exact(torch, towers: dict, wav: np.ndarray) -> dict:
    """On the card: each tower's bucket-padded run (masked statistics)
    against an unpadded run of the exact length, on the valid frames."""
    from simwhisper_codec_tpu_torch.eval.speaker import ecapa_forward, wavlm_weighted_features
    from simwhisper_codec_tpu_torch.eval.utmos import utmos_forward
    from simwhisper_codec_tpu_torch.eval.wer import ctc_logits
    from simwhisper_codec_tpu_torch.models.codec import f32_precision

    asr, utmos, spk = towers["asr"], towers["utmos"], towers["speaker"]
    norm = (wav - wav.mean()) / np.sqrt(wav.var() + 1e-7)
    x = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)[None]).cuda()  # noqa: E731
    with torch.no_grad(), f32_precision("highest"):
        exact_logits = ctc_logits(asr.cfg, asr.params, x(norm))[0][0].cpu().numpy()
        exact_score = float(utmos_forward(utmos.cfg, utmos.params, x(wav))[0])
        feats, _ = wavlm_weighted_features(spk.ssl_cfg, spk.wavlm_params, spk.feature_weight, x(wav))
        exact_emb = ecapa_forward(spk.params, feats)[0].cpu().numpy()
    return {"ctc_logits": tower_err(asr.logits(wav).cpu().numpy(), exact_logits),
            "utmos_score": tower_err(utmos.score(wav), exact_score),
            "embedding": tower_err(spk.embed(wav), exact_emb)}


class ProgramArgs:
    """Stands in for a tower's (or an extractor's) ``program`` attribute:
    keeps the inputs of the last call, then calls the program."""

    def __init__(self, program):
        self.program, self.args = program, None

    def __getattr__(self, name):  # count, source, ... of the program
        return getattr(self.program, name)

    def __call__(self, *args):
        self.args = args
        return self.program(*args)


def host_array(r) -> np.ndarray:
    return r.cpu().numpy() if hasattr(r, "cpu") else np.asarray(r)


def program_check(torch, name: str, owner, call, utts, precision: str = "highest", sr: int = 16000) -> dict:
    """``owner.program`` (a ``utils/aot.py`` program of a tower or an
    extractor) on the card through ``call``, its wrapper's method, on
    utterances of one new signature (bucket): the first call captures one
    new signature, the second replays, held against the same call under
    ``aot.eager()`` (max |d| / max(max |eager|, 1) <= TOWER_TOL; bit for bit
    reported); each other utterance replays and adds no signature; one replay
    runs under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync
    inside it would raise); then the calls over all utterances captured and
    eager in turns (captured, eager, eager, captured; host clock,
    synchronised): ms per call and per audio second, each the mean of its
    two."""
    from simwhisper_codec_tpu_torch.models.codec import f32_precision
    from simwhisper_codec_tpu_torch.utils import aot

    program = owner.program
    rec = owner.program = ProgramArgs(program)
    try:
        before = program.count
        call(utts[0])
        assert program.source == "captured" and program.count == before + 1, (name, program.source, program.count)
        got = host_array(call(utts[0]))
        assert program.source == "replayed", (name, program.source)
        with aot.eager():
            want = host_array(call(utts[0]))
        for u in utts[1:]:
            call(u)
            assert program.source == "replayed" and program.count == before + 1, (name, program.source, program.count)
        with torch.no_grad(), f32_precision(precision):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                program(*rec.args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        times = {"captured": [], "eager": []}
        for setting in ("captured", "eager", "eager", "captured"):
            with aot.eager() if setting == "eager" else contextlib.nullcontext():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for u in utts:
                    call(u)
                torch.cuda.synchronize()
                times[setting].append((time.perf_counter() - t0) * 1e3)
    finally:
        owner.program = program
    audio_s = sum(len(u) for u in utts) / sr
    out = {"bucket_samples": int(rec.args[0].shape[-1]), "signatures": program.count,
           "replay_vs_eager": tower_err(got, want), "bit_for_bit": bool(np.array_equal(got, want)),
           "calls": len(utts), "audio_s": audio_s}
    for setting, ms in times.items():
        out[f"{setting}_ms_per_call"] = float(np.mean(ms)) / len(utts)
        out[f"{setting}_ms_per_audio_s"] = float(np.mean(ms)) / audio_s
    assert out["replay_vs_eager"] <= TOWER_TOL, (name, out)
    return out


def tower_program_check(torch, towers: dict, rng) -> dict:
    """The towers' programs (``program_check``) on two utterances of a new
    bucket (11 s and 13.5 s: 16 s), TF32 off: the CTC logits (and the
    transcripts, captured against eager), UTMOS, the speaker embedding
    through WavLM-large and through fbank (random ECAPA; one signature a
    hop-truncated length, so one utterance)."""
    from simwhisper_codec_tpu_torch.eval.speaker import SpeakerEmbedder
    from simwhisper_codec_tpu_torch.utils import aot

    utts = [voice(rng, s, 16000) for s in (11.0, 13.5)]
    asr, utmos, spk = towers["asr"], towers["utmos"], towers["speaker"]
    fbank = SpeakerEmbedder(None, "fbank", device="cuda")
    out = {"ctc_logits": program_check(torch, "ctc_logits", asr, asr.logits, utts),
           "utmos": program_check(torch, "utmos", utmos, utmos.score, utts),
           "speaker_wavlm": program_check(torch, "speaker_wavlm", spk, spk.embed, utts),
           "speaker_fbank": program_check(torch, "speaker_fbank", fbank, fbank.embed, utts[:1])}
    with aot.eager():
        eager_text = [asr.transcribe(u) for u in utts]
    assert [asr.transcribe(u) for u in utts] == eager_text, "captured transcripts differ from eager ones"
    log(f"[eval] {gpu_line()}: the towers as CUDA graphs (utils/aot.py), full width, TF32 off, against "
        f"aot.eager() (tolerance {TOWER_TOL}; transcripts equal): {json.dumps(out)}")
    return out


def eval_phase(torch, cfg, codec, weights: Path) -> None:
    """The quality evaluation on the card (``eval_corpus.py --full-report``):
    synthetic tower weights at the published widths written by the port's
    tool; a synthetic corpus of 8 FLAC utterances of 4-8 s (seed 0) through
    the serving codec (fast-int8, random weights), the host metrics, the
    code statistics and the three towers (TF32 off; once more with TF32 on
    for the time; each tower timed warm, after a call of each shape it
    meets); each tower on the card against the CPU on a 4 s utterance, and
    bucket-padded against exact length on the card; the
    trainer's held-out probe (``--smoke --steps 4 --eval_every 2``) in a
    child process.  The towers are written into ``weights`` (phase 7 reads
    them there)."""
    from simwhisper_codec_tpu_torch import eval_corpus
    from simwhisper_codec_tpu_torch.ops import _cuda
    from simwhisper_codec_tpu_torch.tools import make_synthetic_tower_weights as tool

    t_phase = time.perf_counter()
    gpu = gpu_line()
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        for make, path in ((tool.make_hubert_ctc, weights / "hubert_ctc"),
                           (tool.make_wavlm_ecapa, weights / "wavlm_large_finetune.pth"),
                           (tool.make_utmos, weights / "utmos22_strong.ckpt")):
            t0 = time.perf_counter()
            info = make(path, 0)
            size = sum(f.stat().st_size for f in ([path] if path.is_file() else path.iterdir()))
            log(f"[eval] synthetic {path.name}: {info['params']} parameters, {size} bytes written, "
                f"{time.perf_counter() - t0:.1f} s (written and loaded back leaf for leaf)")

        corpus = tmp / "corpus"
        eval_corpus.make_synthetic_corpus(corpus, EVAL_FILES, seed=0, dur_range=EVAL_SECONDS)
        towers = dict(asr_model=str(weights / "hubert_ctc"), utmos_ckpt=str(weights / "utmos22_strong.ckpt"),
                      ecapa_ckpt=str(weights / "wavlm_large_finetune.pth"))
        _cuda.reset_launch_counts()
        report = eval_corpus.full_report(codec, str(corpus), str(tmp / "out"), batch_size=8, codebook_stats=True,
                                         **towers)
        launches = dict(_cuda.launch_counts)
        log(f"[eval] report: {json.dumps(report)}")
        want = expected_launches("fast-int8", cfg, 2, 1)  # encode twice (round trip, code statistics), decode once
        assert launches == want, f"eval launches {launches} != {want}"
        q, tw = report["quality"], report["towers"]
        assert report["files"] == EVAL_FILES and q["num_pairs"] == EVAL_FILES and tw["num_pairs"] == EVAL_FILES, report
        metrics = {**{k: q[k] for k in ("stoi", "pesq_wb", "pesq_nb", "si_snr", "snr", "lsd", "mcd")},
                   **{k: tw[k] for k in ("wer_rec", "utmos_rec", "utmos_orig", "speaker_sim")},
                   "entropy": sum(report["codebook"]["entropy_bits_per_group"])}
        bad = {k: v for k, v in metrics.items() if v is None or not np.isfinite(v)}
        assert not bad, f"non-finite metrics: {bad}"
        assert all(v.startswith("ran (") for v in report["gated_metrics"].values()), report["gated_metrics"]
        timing = report["timing"]
        tower_line = "; ".join(
            f"{name} {t['ms_per_audio_s']:.3f} ms per audio s warm ({t['audio_s']:.1f} audio s in {t['run_s']:.2f} s, "
            f"after {t['warmup_s']:.2f} s of warm-up, a call of each shape; weights loaded in {t['load_s']:.1f} s), "
            f"peak max_memory_allocated {t['peak_bytes'] / 1e9:.2f} GB"
            for name, t in timing["towers"].items())
        log(f"[eval] {gpu}: synthetic weights, TF32 off: codec (fast-int8 round trip + code statistics) "
            f"{timing['codec_s']:.2f} s, host metrics (STOI, PESQ-WB/NB, SI-SNR, SNR, LSD, MCD on "
            f"{EVAL_FILES} pairs) {timing['host_metrics_s']:.2f} s; {tower_line}; launches {json.dumps(launches)}")
        tf32 = eval_corpus.tower_metrics(str(corpus), str(tmp / "out" / "reconstructed"), device="cuda",
                                         precision="default", **towers)["timing"]
        log(f"[eval] {gpu}: synthetic weights, TF32 on (timing only, not the default): " + "; ".join(
            f"{name} {t['ms_per_audio_s']:.3f} ms per audio s warm ({t['run_s']:.2f} s, warm-up {t['warmup_s']:.2f} s)"
            for name, t in tf32.items()))

        probe_dir = tmp / "probe"
        probe = start(["-m", TRAIN, "--smoke", "--steps", "4", "--eval_every", "2", "--device", "cuda",
                       "--output_folder", str(probe_dir), "--checkpoint_every", "4"], tmp / "probe.log")
        try:
            rng = np.random.default_rng(3)
            wav = voice(rng, 4.0, 16000)
            t0 = time.perf_counter()
            card = tower_outputs(torch, weights, "cuda", wav)
            cpu = tower_outputs(torch, weights, "cpu", wav)
            errs = {k: tower_err(card[k], cpu[k]) for k in ("ctc_logits", "utmos_score", "embedding")}
            assert card["transcript"] == cpu["transcript"], (card["transcript"], cpu["transcript"])
            assert all(e <= TOWER_TOL for e in errs.values()), errs
            pad = padded_vs_exact(torch, card, voice(rng, 5.3, 16000))
            assert all(e <= TOWER_TOL for e in pad.values()), pad
            tower_program_check(torch, card, rng)
            log(f"[eval] full width, TF32 off: card vs CPU on a 4 s utterance, max|d| / max(max|ref|, 1): "
                f"{json.dumps(errs)} (tolerance {TOWER_TOL}), transcripts equal ({len(card['transcript'])} "
                f"characters); a 5.3 s utterance padded to its 8 s bucket vs its exact length on the card: "
                f"{json.dumps(pad)} ({time.perf_counter() - t0:.1f} s)")
            del card, cpu
            finish("trainer probe", probe, tmp / "probe.log", 300)
        finally:
            if probe.poll() is None:
                probe.kill()
                probe.wait()
        rows = [json.loads(line) for line in (probe_dir / "quality_log.jsonl").read_text().splitlines()]
        assert [r["step"] for r in rows] == [0, 2, 4], rows
        for r in rows:
            assert all(r[k] is not None and np.isfinite(r[k]) for k in ("stoi", "si_snr", "pesq_wb")), r
        log(f"[eval] trainer probe (--smoke --steps 4 --eval_every 2, cuda): quality_log.jsonl {json.dumps(rows)}")
    torch.cuda.empty_cache()
    log(f"[eval] phase: {time.perf_counter() - t_phase:.1f} s")


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


# -- phase 7: the FLOP ledger, a profiler trace, the release drill and the CLI twins --

TOOLS = "simwhisper_codec_tpu_torch.tools"
DRILL_FILES = 8
# what each mode's matmuls run in (MFU divides all of them by the bf16 peak)
MODE_PRECISION = {"parity": "f32, TF32 off", "fast": "bf16",
                  "fast-int8": "bf16 tokenize; int8 decoder and Vocos FFNs"}
# trace event names of each hand kernel of the fast-int8 path (kernel names in csrc/)
TRACE_KERNELS = {
    "B1": ("pflash_sm90_kernel",),
    "B2": ("ln_ffn_bf16_rows_kernel", "ln_ffn_bf16_up_kernel", "ln_ffn_bf16_down_kernel"),
    "B3": ("ln_ffn_int8_rows_kernel", "ln_ffn_int8_upmax_kernel", "ln_ffn_int8_upq_kernel", "ln_ffn_int8_down_kernel"),
}


def flops_ledger(torch, cfg, stage_ms: dict, gpu: str) -> None:
    """Ledger FLOPs per audio second (``utils/flops.py``: one 30 s chunk's
    matmul and convolution FLOPs over 30 s) and MFU = the batch's ledger
    FLOPs per second (8 chunks over phase 3's tokenize + detokenize ms)
    over the card's dense bf16 peak, for parity, fast and fast-int8.  The
    denominator is the bf16 peak for every mode, so each mode's line also
    names the precision its matmuls run in: parity's f32 and fast-int8's
    int8 FFNs have other peaks."""
    from simwhisper_codec_tpu_torch.utils.flops import codec_flops, peak_tflops

    ledger = codec_flops(cfg)
    peak = peak_tflops(torch.cuda.get_device_name(0))
    assert peak > 0, f"no dense bf16 peak known for {torch.cuda.get_device_name(0)}"
    out = {"gpu": gpu, "peak_tflops_bf16": peak, "flops_per_chunk": ledger["total"],
           "flops_per_audio_sec": ledger["total"] / cfg.max_audio_seconds, "modes": {}}
    for mode, precision in MODE_PRECISION.items():
        s = (stage_ms[mode]["tokenize_ms"] + stage_ms[mode]["detokenize_ms"]) / 1e3
        out["modes"][mode] = {"batch8_s": s, "mfu": 8 * ledger["total"] / s / (peak * 1e12), "precision": precision}
    log(f"[tools] FLOP ledger: {json.dumps(out)}")


def trace_check(torch, cfg, codec, out_dir: Path) -> None:
    """One fast-int8 ``inference_tokenize`` + ``inference_detokenize`` of a
    batch of 8 x 30 s traced with ``utils/profiling.trace``, each stage in an
    ``annotate`` region and timed by ``StageTimer``: the trace file names the
    two regions and every pass of B1, B2 and B3, and the launches are the
    ones ``expected_launches`` gives for one chunk each way."""
    from simwhisper_codec_tpu_torch.ops import _cuda
    from simwhisper_codec_tpu_torch.utils import profiling

    batch = np.random.default_rng(8).standard_normal((8, cfg.chunk_samples)).astype(np.float32) * 0.1
    lens = np.full(len(batch), batch.shape[1])
    tok = codec.inference_tokenize(batch, lens)  # warm
    codec.inference_detokenize(tok["codes"].cpu().numpy(), tok["codes_lengths"].cpu().numpy())
    timer, anchor = profiling.StageTimer(sync=True), torch.zeros(1, device=codec.device)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    with profiling.trace(str(out_dir)):
        with timer.stage("tokenize", block_on=anchor), profiling.annotate("fast-int8.tokenize"):
            tok = codec.inference_tokenize(batch, lens)
        codes, code_lens = tok["codes"].cpu().numpy(), tok["codes_lengths"].cpu().numpy()
        with timer.stage("detokenize", block_on=anchor), profiling.annotate("fast-int8.detokenize"):
            codec.inference_detokenize(codes, code_lens)
    launches = dict(_cuda.launch_counts)
    want = expected_launches("fast-int8", cfg, 1, 1)
    assert launches == want, f"traced launches {launches} != {want}"
    files = sorted(out_dir.glob("*.pt.trace.json"))
    assert len(files) == 1, files
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    missing = [r for r in ("fast-int8.tokenize", "fast-int8.detokenize") if r not in names]
    missing += [f"{b}:{frag}" for b, frags in TRACE_KERNELS.items() for frag in frags
                if not any(frag in k for k in kernels)]
    assert not missing, f"the trace does not name {missing}"
    found = {b: sum(1 for e in events if e.get("cat") == "kernel" and any(f in e.get("name", "") for f in frags))
             for b, frags in TRACE_KERNELS.items()}
    log(f"[tools] trace {files[0].name} ({files[0].stat().st_size} bytes, {len(events)} events): regions "
        f"fast-int8.tokenize / fast-int8.detokenize, kernel events {json.dumps(found)}; launches {json.dumps(launches)}; "
        f"StageTimer (traced, synchronised):\n{timer.report()}")


def drill_codec_check(torch, cfg, config_path: str, work: Path, readiness: dict, tmp: Path) -> None:
    """The drill's codec in process: its ``.pt`` through
    ``AudioCodec.load_from_checkpoint`` in the corpus stage's mode (fast) on
    the corpus stage's files, with the launches ``expected_launches``
    predicts (one batch: one chunk each way), the child's bitrate (its code
    frames) and reconstructions (byte for byte: the WAVs decoded from its
    codes), and the checksum report the loader logs equal to the load
    stage's file."""
    import logging

    from simwhisper_codec_tpu_torch.eval.corpus import evaluate_corpus
    from simwhisper_codec_tpu_torch.models.codec import AudioCodec
    from simwhisper_codec_tpu_torch.ops import _cuda
    from simwhisper_codec_tpu_torch.utils import checkpoint

    records = []
    handler = logging.Handler(logging.INFO)
    handler.emit = records.append
    ck_logger = logging.getLogger(checkpoint.__name__)
    prev_level = ck_logger.level
    ck_logger.addHandler(handler)
    ck_logger.setLevel(logging.INFO)
    try:
        codec = AudioCodec.load_from_checkpoint(config_path, readiness["codec_checkpoint"],
                                                batch_size=8, mode="fast", device="cuda")
    finally:
        ck_logger.removeHandler(handler)
        ck_logger.setLevel(prev_level)
    reports = [r.getMessage().split("\n", 1)[1] for r in records if "tensor report" in r.getMessage()]
    assert len(reports) == 1, [r.getMessage()[:200] for r in records]
    assert reports[0] + "\n" == (work / "checksums.txt").read_text(), "logged checksum report != checksums.txt"
    recon = tmp / "drill_in_process"
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    stats = evaluate_corpus(codec, str(work / "corpus_out" / "synthetic_corpus"), str(recon), batch_size=8)
    torch.cuda.synchronize()
    launches = dict(_cuda.launch_counts)
    want = expected_launches("fast", cfg, 1, 1)
    assert stats["files"] == DRILL_FILES and stats["num_batches"] == 1, stats
    assert launches == want, f"drill codec launches {launches} != {want}"
    child_bitrate = readiness["stages"]["corpus"]["quality"]["bitrate_bps"]
    assert stats["bitrate_bps"] == child_bitrate, (stats["bitrate_bps"], child_bitrate)
    child = work / "corpus_out" / "reconstructed"
    names = sorted(f.name for f in child.iterdir())
    assert names == sorted(f.name for f in recon.iterdir()) and len(names) == DRILL_FILES, names
    differ = [n for n in names if (recon / n).read_bytes() != (child / n).read_bytes()]
    assert not differ, f"in-process reconstructions differ from the drill's: {differ}"
    log(f"[tools] drill codec in process (fast, {DRILL_FILES} files, one batch): launches {json.dumps(launches)} == "
        f"expected_launches('fast', cfg, 1, 1); bitrate {child_bitrate} bps and every reconstruction (byte for "
        f"byte) == the drill child's; the loader's logged checksum report == checksums.txt "
        f"({len(reports[0].splitlines())} tensors)")
    del codec


def cli_checks(torch, work: Path, weights: Path, report: dict, tmp: Path) -> None:
    """The CLI twins as children on the card, on the drill's originals and
    reconstructions with the phase-4 towers, against the drill's report:
    host metrics equal at the report's precision (4 decimals); WER (from the
    printed counts) and SIM (printed to 4 decimals) within 1e-4; UTMOS at
    its printed precision (3 decimals), and scored in process by the tool's
    scorer within 1e-4.  The WER references are the originals' own
    transcripts, as the report scores without transcripts."""
    from simwhisper_codec_tpu_torch.eval.wer import CTCTranscriber
    from simwhisper_codec_tpu_torch.tools.utmos.utmos_model import UTMOSScorer
    from simwhisper_codec_tpu_torch.utils.audio_io import find_audio_files, load_audio

    orig, recon = work / "corpus_out" / "synthetic_corpus", work / "corpus_out" / "reconstructed"
    asr = CTCTranscriber(str(weights / "hubert_ctc"), device="cuda")
    lines = [f"{Path(p).stem} {asr.transcribe(load_audio(p, 16000))}" for p in find_audio_files(str(orig))]
    del asr
    assert all(len(line.split(" ", 1)) == 2 and line.split(" ", 1)[1] for line in lines), lines
    (orig / "orig.trans.txt").write_text("\n".join(lines) + "\n")
    ecapa, utmos = str(weights / "wavlm_large_finetune.pth"), str(weights / "utmos22_strong.ckpt")
    dirs = ["--original_dir", str(orig), "--synthesized_dir", str(recon)]
    children = {
        "evaluate_model": [f"{TOOLS}.base_eval.evaluate_model", *dirs, "--output_json", str(tmp / "eval.json")],
        "calculate_wer": [f"{TOOLS}.wer.calculate_wer", *dirs, "--model", str(weights / "hubert_ctc")],
        "spk_sim_cal": [f"{TOOLS}.speaker.spk_sim_cal", *dirs, "--ecapa_checkpoint", ecapa],
        "extract_spk_emb orig": [f"{TOOLS}.speaker.extract_spk_emb", "--input_dir", str(orig),
                                 "--emb_dir", str(tmp / "emb_orig"), "--ecapa_checkpoint", ecapa],
        "extract_spk_emb recon": [f"{TOOLS}.speaker.extract_spk_emb", "--input_dir", str(recon),
                                  "--emb_dir", str(tmp / "emb_recon"), "--ecapa_checkpoint", ecapa],
        "calculate_utmos": [f"{TOOLS}.utmos.calculate_utmos", "--input_dir", str(recon), "--ckpt", utmos],
    }
    t0 = time.perf_counter()
    procs = {name: start(["-m", *args], tmp / f"{name.replace(' ', '_')}.log", env=dict(os.environ))
             for name, args in children.items()}
    outs, walls = {}, {}
    try:
        for name, proc in procs.items():
            outs[name] = finish(name, proc, tmp / f"{name.replace(' ', '_')}.log", 600)
            walls[name] = time.perf_counter() - t0
        npy = start(["-m", f"{TOOLS}.speaker.spk_sim_cal", *dirs, "--orig_emb_dir", str(tmp / "emb_orig"),
                     "--synth_emb_dir", str(tmp / "emb_recon")], tmp / "spk_npy.log", env=dict(os.environ))
        procs["spk_sim_cal npy"] = npy
        outs["spk_sim_cal npy"] = finish("spk_sim_cal npy", npy, tmp / "spk_npy.log", 300)
        walls["spk_sim_cal npy"] = time.perf_counter() - t0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    q, tw = report["quality"], report["towers"]
    host = json.loads((tmp / "eval.json").read_text())
    assert host["num_pairs"] == q["num_pairs"] == DRILL_FILES, (host, q)
    host_diff = {k: (round(host[k], 4), q[k]) for k in ("stoi", "pesq_wb", "pesq_nb", "si_snr", "snr", "lsd", "mcd")
                 if round(host[k], 4) != q[k]}
    assert not host_diff, f"evaluate_model != the drill's host metrics: {host_diff}"
    m = re.search(r"reconstructed: utterances=(\d+) WER=\S+ \(cor=(\d+) sub=(\d+) del=(\d+) ins=(\d+)\)",
                  outs["calculate_wer"])
    assert m and int(m[1]) == DRILL_FILES, outs["calculate_wer"][-2000:]
    cor, sub, dele, ins = (int(m[i]) for i in range(2, 6))
    wer = (sub + dele + ins) / max(cor + sub + dele, 1)
    utmos_printed = float(re.search(rf"UTMOS mean over {DRILL_FILES} files: (\S+)", outs["calculate_utmos"])[1])
    scorer = UTMOSScorer(utmos, device="cuda")
    utmos_mean = float(np.mean([scorer.score(load_audio(p, 16000), 16000) for p in find_audio_files(str(recon))]))
    del scorer
    sims = {k: float(re.search(rf"SIM mean over {DRILL_FILES} pairs: (\S+)", outs[k])[1])
            for k in ("spk_sim_cal", "spk_sim_cal npy")}
    errs = {"wer": abs(wer - tw["wer_rec"] / 100), "utmos": abs(utmos_mean - tw["utmos_rec"]),
            **{f"sim ({k})": abs(v - tw["speaker_sim"]) for k, v in sims.items()}}
    # the report rounds WER to 1e-5 (3 decimals of a percentage), UTMOS and
    # SIM to 1e-4; a SIM printed to 4 decimals can sit one step from it
    assert all(e <= 1e-4 + 1e-9 for e in errs.values()), errs
    # the tool prints UTMOS to 3 decimals: within half a step of it and the
    # report's own rounding
    assert abs(utmos_printed - tw["utmos_rec"]) <= 5.5e-4 + 1e-9, (utmos_printed, tw["utmos_rec"])
    log(f"[tools] CLI twins on the card vs the drill's report ({DRILL_FILES} pairs): host metrics equal at 4 "
        f"decimals; |d| WER {errs['wer']:.3g}, UTMOS {errs['utmos']:.3g} (in process; the child printed "
        f"{utmos_printed:.3f}), SIM {errs['sim (spk_sim_cal)']:.3g} "
        f"(files) / {errs['sim (spk_sim_cal npy)']:.3g} (.npy) (tolerance 1e-4); WER {100 * wer:.3f} % "
        f"(cor={cor} sub={sub} del={dele} ins={ins}), UTMOS {utmos_mean:.5f}, SIM {sims}; side by side, each "
        f"child done after (s): {json.dumps({k: round(v, 1) for k, v in walls.items()})}")


def tools_phase(torch, cfg, codec, stage_ms: dict, weights: Path,
                config_path: str = "config/SimWhisperCodec.yaml") -> None:
    """Phase 7: the FLOP ledger and MFU per mode, a profiler trace of the
    serving codec, ``release_check --dry_run --corpus_n 8`` as a child (with
    phase 4's towers; its bench stage runs the port's bench), the drill's
    codec in process, and the CLI twins."""
    from simwhisper_codec_tpu_torch.ops import _cuda

    t_phase = time.perf_counter()
    gpu = gpu_line()
    flops_ledger(torch, cfg, stage_ms, gpu)
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        trace_check(torch, cfg, codec, tmp / "trace")
        work = tmp / "drill"
        t0 = time.perf_counter()
        drill = start(["-m", f"{TOOLS}.release_check", "--dry_run", "--corpus_n", str(DRILL_FILES),
                       "--config", config_path, "--workdir", str(work), "--asr_model", str(weights / "hubert_ctc"),
                       "--utmos_checkpoint", str(weights / "utmos22_strong.ckpt"),
                       "--ecapa_checkpoint", str(weights / "wavlm_large_finetune.pth")],
                      tmp / "drill.log", env={**{k: v for k, v in os.environ.items() if not k.startswith("BENCH_")},
                                              "BENCH_AOT_DIR": str(_cuda.build_dir())})
        try:
            finish("release_check --dry_run", drill, tmp / "drill.log", 600)
        finally:
            if drill.poll() is None:
                drill.kill()
                drill.wait()
        drill_s = time.perf_counter() - t0
        readiness = json.loads((work / "READINESS.json").read_text())
        stages = readiness["stages"]
        assert readiness["ready"] and stages["load"]["ok"] and stages["corpus"]["ok"], readiness
        assert stages["corpus"]["gated_metrics"] == [], stages["corpus"]
        assert stages["parity"] == {"ok": None, "skipped": "reference repo not mounted",
                                    "wall_s": stages["parity"]["wall_s"]}, stages["parity"]
        assert stages["bench"]["ok"] is True, stages["bench"]
        check_bench_line(torch, cfg, stages["bench"]["metric"], "release_check's bench stage")
        report = json.loads(Path(stages["corpus"]["report"]).read_text())
        log(f"[tools] {gpu}: release_check --dry_run --corpus_n {DRILL_FILES}: ready, {drill_s:.1f} s (the "
            f".pt of {stages['load']['parameters']} parameters written first); stage wall s "
            f"{json.dumps({k: v['wall_s'] for k, v in stages.items()})}; parity skipped "
            f"({stages['parity']['skipped']}); bench {json.dumps(stages['bench']['metric'])}; corpus quality "
            f"{json.dumps(stages['corpus']['quality'])}; report timing {json.dumps(report['timing'])}")
        drill_codec_check(torch, cfg, config_path, work, readiness, tmp)
        torch.cuda.empty_cache()
        cli_checks(torch, work, weights, report, tmp)
    torch.cuda.empty_cache()
    log(f"[tools] phase: {time.perf_counter() - t_phase:.1f} s")


# -- phase 7b: the bench (``simwhisper_codec_tpu_torch/bench.py``) -------------

BENCH_BATCH, BENCH_ITERS = 16, 10  # the bench's defaults
# the 16 keys of the JAX bench.py's JSON line, in its order
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "headline_mode", "bf16_x_realtime", "latency_x_realtime",
              "flops_per_audio_sec", "flops_unit", "achieved_tflops", "device", "peak_tflops_bf16", "mfu",
              "int8_x_realtime", "int8_code_agreement_vs_bf16", "int8_mixed_x_realtime")
BENCH_RATES = ("value", "bf16_x_realtime", "latency_x_realtime", "int8_x_realtime", "int8_mixed_x_realtime")
# the JAX package's floor for fast-int8-full codes against fast codes
# (tests/test_torch_informative_codes.py): a lower agreement is a finding
BENCH_AGREEMENT_FLOOR = 0.85
BENCH_ACC_RTOL = 1e-6  # the chained accumulator against n x one round trip's
BENCH_WAVE_RTOL = 1e-3  # bench vs serving waveform where not bit for bit: max |d| <= RTOL * max |y|
# launch run of the kernel line -> (bench section, the AudioCodec mode serving its programs, kernels it must launch)
BENCH_RUNS = {
    "bench-fast": ("fast(bf16)", "fast", ("pflash_attention", "ln_ffn_bf16")),
    "bench-fast-int8-mixed": ("fast-int8(mixed)", "fast-int8", ("pflash_attention", "ln_ffn_bf16", "ln_ffn_int8")),
    "bench-fast-int8-full": ("fast-int8(full)", "fast-int8-full", ("pflash_attention", "ln_ffn_int8")),
    "bench-fast-dw": ("fast(bf16)", "fast", ("pflash_attention", "ln_ffn_bf16", "convnext_dw")),
}
# launch run -> the bf16 detokenize's Vocos (SIMWHISPER_FUSED_VOCOS=dw in the bench); the others run "fused"
BENCH_VOCOS = {"bench-fast-dw": "fused-dw"}


def check_bench_line(torch, cfg, rec: dict, where: str) -> None:
    """A bench JSON line on this card: the JAX bench's keys, finite positive
    rates, the int8 (mixed) headline, ``vs_baseline`` = value / 10, the
    ledger's FLOPs, MFU from ``bf16_x_realtime`` over the card's peak, code
    agreement at or above the floor."""
    from simwhisper_codec_tpu_torch.utils.flops import codec_flops, peak_tflops

    assert tuple(rec) == BENCH_KEYS, f"{where}: keys {list(rec)}"
    bad = {k: rec[k] for k in BENCH_RATES if not (isinstance(rec[k], (int, float)) and np.isfinite(rec[k])
                                                   and rec[k] > 0)}
    assert not bad, f"{where}: rates {bad}"
    assert rec["headline_mode"] == "fast-int8(mixed)" and rec["value"] == rec["int8_mixed_x_realtime"], rec
    assert rec["vs_baseline"] == round(rec["value"] / 10, 3), rec
    name = torch.cuda.get_device_name(0)
    peak = peak_tflops(name)
    assert rec["device"] == name and rec["peak_tflops_bf16"] == peak > 0, rec
    flops = codec_flops(cfg)["total"] / (cfg.chunk_samples / cfg.input_sample_rate)
    assert rec["flops_per_audio_sec"] == round(flops / 1e9, 2), rec
    mfu = flops * rec["bf16_x_realtime"] / 1e12 / peak  # from the printed rate: within its rounding
    assert abs(rec["mfu"] - mfu) <= 5e-5 + flops * 0.005 / 1e12 / peak, (rec["mfu"], mfu)
    assert rec["int8_code_agreement_vs_bf16"] >= BENCH_AGREEMENT_FLOOR, rec


def bench_in_process(torch, cfg, model) -> dict:
    """The bench's programs (``bench.programs`` on the resident model, on the
    bench's 16 x 30 s batch) against serving, per section: codes equal to
    ``AudioCodec(mode, batch_size=16)``'s ``inference_tokenize``, the
    waveform of ``inference_detokenize`` bit for bit (else within
    ``BENCH_WAVE_RTOL`` of max |y|); the launches of one replayed round trip
    equal to the graphs' recorded launches and to ``AudioCodec``'s, and
    nonzero for each kernel the section runs; ``BENCH_ITERS`` chained round
    trips under ``torch.cuda.set_sync_debug_mode("error")`` (a replay that
    synchronised would raise) whose accumulator equals n x one round trip's,
    the host's enqueue time beside the whole.  ``bench-fast-dw`` is the bf16
    section with ``SIMWHISPER_FUSED_VOCOS=dw`` (``bench.programs(model,
    "fused-dw")``) against ``AudioCodec(mode="fast", vocos_impl="fused-dw")``:
    B4 on every Vocos block, B2's Vocos chain on none.  Then the bench's
    ``bf16_x_realtime`` with each Vocos, as ``bench.run`` measures it (its
    pipelined round trips), in turns.  Returns launches by run and the
    bench's (fused) programs."""
    from simwhisper_codec_tpu_torch import bench
    from simwhisper_codec_tpu_torch.models.codec import AudioCodec, f32_precision, quantize_for_mode
    from simwhisper_codec_tpu_torch.ops import _cuda

    quantize_for_mode(model, "fast-int8-full")
    progs = {vocos: bench.programs(model, vocos) for vocos in ("fused", "fused-dw")}
    batch_inputs = bench.inputs(cfg, BENCH_BATCH, "cuda")
    wav, lengths, frame_valid = batch_inputs
    wav_np, lens_np = wav.cpu().numpy(), lengths.cpu().numpy()
    rts = {vocos: bench.round_trips(p, batch_inputs) for vocos, p in progs.items()}
    zero = torch.zeros((), device="cuda")
    launches_by_run, report = {}, {}
    for run, (section, mode, kernels) in BENCH_RUNS.items():
        vocos = BENCH_VOCOS.get(run, "fused")
        tok, detok = (progs[vocos][name] for name in bench.SECTIONS[section])
        rt = rts[vocos][section]
        with torch.no_grad(), f32_precision("default"):
            rt(zero)  # captures the section's programs not yet captured
            torch.cuda.synchronize()
            _cuda.reset_launch_counts()
            one = float(rt(zero)[0])
            launches = dict(_cuda.launch_counts)
            recorded = {}
            for program in (tok, detok):
                assert program.count == 1 and program.source == "replayed", (run, program.name, program.count)
                (graph,) = program._programs.values()
                for key, n in graph.launches.items():
                    recorded[key] = recorded.get(key, 0) + n
            t = tok(wav, lengths)
            y = detok(t["codes"], t["codes_lengths"], frame_valid)["y"]
            torch.cuda.set_sync_debug_mode("error")
            try:
                t0 = time.perf_counter()
                acc = bench.chain(rt, zero, BENCH_ITERS)
                enqueue_s = time.perf_counter() - t0
            finally:
                torch.cuda.set_sync_debug_mode("default")
            chained = float(acc)
            chain_s = time.perf_counter() - t0
        assert abs(chained - BENCH_ITERS * one) <= BENCH_ACC_RTOL * BENCH_ITERS * abs(one), (run, chained, one)
        codec = AudioCodec(cfg, model, batch_size=BENCH_BATCH, mode=mode, device="cuda",
                           vocos_impl=BENCH_VOCOS.get(run))
        warm = codec.inference_tokenize(wav_np, lens_np)  # captures
        codec.inference_detokenize(warm["codes"].cpu().numpy(), warm["codes_lengths"].cpu().numpy())
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        ref = codec.inference_tokenize(wav_np, lens_np)
        ref_y = codec.inference_detokenize(ref["codes"].cpu().numpy(), ref["codes_lengths"].cpu().numpy())["y"]
        torch.cuda.synchronize()
        serving = dict(_cuda.launch_counts)
        assert launches == recorded == serving, f"{run}: launches {launches}, graphs {recorded}, serving {serving}"
        if mode in ("fast", "fast-int8"):  # fast-dw: B4 on every Vocos block, B2's Vocos chain on none
            assert launches == expected_launches("fast-dw" if run in BENCH_VOCOS else mode, cfg, 1, 1), (run, launches)
        missing = [k for k in kernels if not any(key.split(":")[0] == k and n > 0 for key, n in launches.items())]
        assert not missing, f"{run}: no launch of {missing}"
        assert torch.equal(t["codes"], ref["codes"]), f"{run}: bench codes differ from serving codes"
        bits = torch.equal(y, ref_y)
        wave_err = float((y.float() - ref_y.float()).abs().max())
        y_max = float(ref_y.float().abs().max())
        assert bits or wave_err <= BENCH_WAVE_RTOL * y_max, f"{run}: waveform {wave_err:.3g} vs max |y| {y_max:.3g}"
        report[run] = {"serving_mode": mode, "codes_equal": True, "waveform_bit_for_bit": bits,
                       "waveform_max_abs_diff": wave_err, "launches": launches, "one_round_trip_sum": one,
                       "chained_sum": chained, "chain_enqueue_s": enqueue_s, "chain_s": chain_s,
                       "enqueue_share": enqueue_s / chain_s}
        assert enqueue_s < 0.5 * chain_s, f"{run}: the chain's host enqueue took {enqueue_s:.3f} of {chain_s:.3f} s"
        launches_by_run[run] = launches
        del codec, warm, ref, ref_y, t, y
        torch.cuda.empty_cache()
    log(f"[bench] in process, batch {BENCH_BATCH} x 30 s: {json.dumps(report)}")
    audio_s = BENCH_ITERS * BENCH_BATCH * cfg.chunk_samples / cfg.input_sample_rate
    rates = {"fused": [], "fused-dw": []}
    with torch.no_grad(), f32_precision("default"):
        for vocos in ("fused", "fused-dw", "fused-dw", "fused"):
            rates[vocos].append(audio_s / bench.pipelined_s(rts[vocos]["fast(bf16)"], BENCH_ITERS, zero, vocos))
    log(f"[bench] {gpu_line()}: bf16_x_realtime (pipelined fast round trips, batch {BENCH_BATCH} x 30 s, "
        f"{BENCH_ITERS} iterations, in turns) by SIMWHISPER_FUSED_VOCOS: unset (fused) "
        f"{', '.join(f'{r:.2f}' for r in rates['fused'])}; dw (fused-dw, B4) "
        f"{', '.join(f'{r:.2f}' for r in rates['fused-dw'])}")
    return launches_by_run, progs["fused"]


def median_synced_ms(torch, fn, reps: int = 5) -> float:
    """Median host ms of ``fn`` between two synchronisations, after one untimed call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def staging_check(torch, cfg, codec, progs) -> dict:
    """The serving codec (fast-int8, batch 8) against the bench's programs of
    the same mode at batch 8, in this process: ``inference_tokenize`` from a
    host array (padding and the host-to-device copy included) against the
    bench's tokenize on the batch already on the card, and
    ``inference_detokenize`` against the bench's int8 detokenize; the
    tokenize difference is the input staging that the bench leaves out."""
    from simwhisper_codec_tpu_torch import bench
    from simwhisper_codec_tpu_torch.models.codec import f32_precision

    wav, lengths, frame_valid = bench.inputs(cfg, 8, "cuda")
    wav_np, lens_np = wav.cpu().numpy(), lengths.cpu().numpy()
    tok = codec.inference_tokenize(wav_np, lens_np)
    codes_np, clen_np = tok["codes"].cpu().numpy(), tok["codes_lengths"].cpu().numpy()
    out = {"serving_tokenize_ms": median_synced_ms(torch, lambda: codec.inference_tokenize(wav_np, lens_np)),
           "serving_detokenize_ms": median_synced_ms(torch, lambda: codec.inference_detokenize(codes_np, clen_np))}
    with torch.no_grad(), f32_precision("default"):
        t = progs["tok"](wav, lengths)
        out["bench_tokenize_ms"] = median_synced_ms(torch, lambda: progs["tok"](wav, lengths))
        out["bench_detokenize_ms"] = median_synced_ms(
            torch, lambda: progs["detok8"](t["codes"], t["codes_lengths"], frame_valid))
    assert np.array_equal(t["codes"].cpu().numpy(), codes_np), "bench codes differ from serving codes at batch 8"
    out["tokenize_staging_ms"] = out["serving_tokenize_ms"] - out["bench_tokenize_ms"]
    for who in ("serving", "bench"):
        out[f"{who}_batch8_x_real_time"] = 240.0 / ((out[f"{who}_tokenize_ms"] + out[f"{who}_detokenize_ms"]) / 1e3)
    log(f"[bench] fast-int8 at batch 8 x 30 s, host clock around synchronised calls, median of 5: "
        f"{json.dumps(out)}")
    return out


def bench_phase(torch, cfg, model, serving_codec) -> dict:
    """Phase 7b: the bench's programs in process against serving
    (``bench_in_process``) and the serving codec's input staging
    (``staging_check``); the bench itself ran as the drill's bench stage
    (phase 7).  Returns launches by run."""
    t0 = time.perf_counter()
    launches, progs = bench_in_process(torch, cfg, model)
    staging_check(torch, cfg, serving_codec, progs)
    del progs
    torch.cuda.empty_cache()
    log(f"[bench] phase: {time.perf_counter() - t0:.1f} s")
    return launches


# -- phase 5: training (each run a subprocess: this process initialised cuBLAS
# before the trainer's deterministic workspace setting could take effect) ----

TRAIN = "simwhisper_codec_tpu_torch.experiments.codec.train"
SOAK = "simwhisper_codec_tpu_torch.experiments.codec.soak"
LOSS_KEYS = ("g_loss", "d_loss", "adv", "feat_match", "mel_l1")
GRAD_TOL = 1.5e-3  # max|d| / max(|ref|, 1e-4) per tensor: the JAX package's multichip tolerance


def det_env(**extra) -> dict:
    return dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8", **extra)


def start(args, log_path: Path, env=None) -> subprocess.Popen:
    """A child process with its output in ``log_path``."""
    with open(log_path, "w") as f:
        return subprocess.Popen([sys.executable, *args], stdout=f, stderr=subprocess.STDOUT, env=env or det_env())


def finish(name: str, proc: subprocess.Popen, log_path: Path, timeout: float) -> str:
    """Wait for a child; raise with the tail of its output unless it exited 0.
    Returns its output."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    text = log_path.read_text()
    if rc != 0:
        raise RuntimeError(f"{name} failed (rc {rc}):\n{text[-4000:]}")
    return text


def train_log(folder: Path) -> list:
    return [json.loads(line) for line in (folder / "train_log.jsonl").read_text().splitlines() if line.strip()]


def voice(rng, seconds: float, sr: int) -> np.ndarray:
    """A harmonic voice-like signal with a wandering pitch and a syllable envelope."""
    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(90, 220) * (1.0 + 0.06 * np.sin(2 * np.pi * rng.uniform(1.5, 3.0) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(h * phase + rng.uniform(0, 6)) / h ** rng.uniform(0.5, 0.9) for h in range(1, 24))
    x *= np.clip(np.sin(2 * np.pi * rng.uniform(1.2, 2.2) * t) * 4.0, 0.0, 1.0)
    x = x + 0.005 * rng.standard_normal(len(t))
    return (0.2 * x / np.max(np.abs(x))).astype(np.float32)


def training_phase(torch) -> None:
    """The discriminators timed with deterministic kernels
    (``discriminator_timing``); full-width codec GAN steps through the
    trainer (CodecConfig(), seed 0, batch 16 x 2 s, lr 2e-4): step 1 warms
    up and captures the step's CUDA graph, 2-6 replay it, 3-6 are timed;
    the ``--check train-graph`` child (``train_graph_check``); then, side by
    side, a fresh process resuming from step 3's checkpoint (capturing
    again), which must log steps 4-6 bit for bit, the SIGKILL soak at
    --smoke width, one GAN step on the card against the CPU, and the DP
    checks under a world-size-1 NCCL group (``dp_phase``)."""
    from simwhisper_codec_tpu_torch.utils.audio_io import save_audio

    t_phase = time.perf_counter()
    discriminator_timing(torch)
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        data = tmp / "wavs"
        data.mkdir()
        rng = np.random.default_rng(11)
        for i in range(8):
            save_audio(data / f"v{i}.wav", voice(rng, 4.0, 16000), 16000)
        common = ["-m", TRAIN, "--data_folder", str(data), "--seed", "0", "--log_every", "1", "--device", "cuda",
                  "--steps", "6", "--checkpoint_every", "3"]
        t0 = time.perf_counter()
        finish("full-width trainer", start(common + ["--output_folder", str(tmp / "A")], tmp / "A.log"), tmp / "A.log",
               600)
        wall_a = time.perf_counter() - t0
        log_a = train_log(tmp / "A")
        assert [r["step"] for r in log_a] == list(range(1, 7)), log_a
        for r in log_a:
            assert all(np.isfinite(r[k]) for k in LOSS_KEYS), r
        assert [r["program"] for r in log_a] == ["captured"] + ["replayed"] * 5, log_a
        timed = [r["step_ms"] for r in log_a if r["step"] >= 3]
        ms = float(np.mean(timed))
        log(f"[train] {gpu_line()}: full width, batch 16 x 2 s: {ms:.1f} ms a step replayed (steps 3-6: "
            f"{', '.join(f'{v:.1f}' for v in timed)}; step 1, the warm-up step and the capture, "
            f"{log_a[0]['step_ms']:.1f}), {16 * 2.0 / (ms / 1e3):.1f} audio s trained a GPU s, "
            f"peak max_memory_allocated {log_a[-1]['max_memory_allocated'] / 1e9:.2f} GB; "
            + "; ".join(re.sub(r"^.*INFO : ", "", line) for line in (tmp / "A.log").read_text().splitlines()
                        if "signature(s)" in line))
        losses = {r["step"]: {k: r[k] for k in LOSS_KEYS} for r in log_a}
        log(f"[train] losses: {json.dumps(losses)} (run: {wall_a:.1f} s; "
            + "; ".join(re.sub(r"^.*INFO : ", "", line) for line in (tmp / "A.log").read_text().splitlines()
                        if "models ready" in line or "saved in" in line) + ")")

        text = finish("train-graph", start([__file__, "--check", "train-graph"], tmp / "graph.log"), tmp / "graph.log",
                      600)
        for line in text.splitlines():
            if line.startswith("[train-graph]"):
                log(line)

        t0 = time.perf_counter()
        children = {
            "resume": (start(common + ["--output_folder", str(tmp / "B"),
                                       "--resume", str(tmp / "A" / "ckpt_0000003.pt")], tmp / "B.log"), tmp / "B.log"),
            "soak": (start(["-m", SOAK, "--output_folder", str(tmp / "soak"), "--steps", "30", "--timeout", "300",
                            "--smoke", "--device", "cuda"], tmp / "soak.log"), tmp / "soak.log"),
            "card-vs-cpu": (start([__file__, "--check", "card-vs-cpu"], tmp / "cvc.log"), tmp / "cvc.log"),
            "dp": (start([__file__, "--dp_gpus", "1", "--work_dir", str(tmp / "dp")], tmp / "dp.log"), tmp / "dp.log"),
        }
        try:
            walls = {}
            while len(walls) < len(children) and time.perf_counter() - t0 < 600:
                for name, (proc, _) in children.items():
                    if name not in walls and proc.poll() is not None:
                        walls[name] = round(time.perf_counter() - t0, 1)
                time.sleep(0.2)
            outs = {name: finish(name, proc, path, 1) for name, (proc, path) in children.items()}
        finally:
            for proc, _ in children.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        log(f"[train] side by side, each child's wall time (s): {json.dumps(walls)}")
        log_b = train_log(tmp / "B")
        assert [r["step"] for r in log_b] == [4, 5, 6], log_b
        assert [r["program"] for r in log_b] == ["captured", "replayed", "replayed"], log_b
        for rb in log_b:
            ra = log_a[rb["step"] - 1]
            assert all(ra[k] == rb[k] for k in LOSS_KEYS), f"resumed step {rb['step']} differs: {ra} vs {rb}"
        log(f"[train] full width: a fresh process resumed from step 3's checkpoint (step 4 its warm-up and "
            f"capture, 5-6 replays) logs steps 4-6 bit for bit equal to the continuous run's replays")
        soak = json.loads((tmp / "soak" / "SOAK_REPORT.json").read_text())
        assert soak["equivalent"] and "SIGKILL" in outs["soak"], soak
        soak_a, soak_b = (train_log(tmp / "soak" / run) for run in ("runA", "runB"))
        assert soak_a[0]["program"] == "captured" and {r["program"] for r in soak_a[1:]} == {"replayed"}, soak_a
        resumed_rows = [r for r in soak_b if r["step"] > soak["resume_step"]][-(30 - soak["resume_step"]):]
        assert [r["program"] for r in resumed_rows] == ["captured"] + ["replayed"] * (len(resumed_rows) - 1), soak_b
        log(f"[train] soak (--smoke, 30 steps, captured): SIGKILL at logged step >= {soak['kill_step']}, resumed "
            f"from step {soak['resume_step']} (captured again), {soak['post_resume_points_checked']} post-resume "
            f"losses bit-equal")
        for name in ("card-vs-cpu", "dp"):
            for line in outs[name].splitlines():
                if line.startswith("[train]"):
                    log(line)
    log(f"[train] phase: {time.perf_counter() - t_phase:.1f} s")


def discriminator_timing(torch, settings=("deterministic",)) -> dict:
    """Where the trainer spends most: the discriminators' forward + backward at
    its batch (16 x 2 s, TF32 off), MPD and MSD apart, in each of
    ``settings`` in turn: "deterministic" (the trainer's: deterministic
    algorithms, no autotuning) or "autotuned" (cuDNN benchmark mode, which
    the trainer never uses).  Runs in this process: the workspace setting is
    set for the deterministic readings' cuBLAS check; the convolutions are
    cuDNN's."""
    from simwhisper_codec_tpu_torch.models.codec import f32_precision
    from simwhisper_codec_tpu_torch.models.hifigan import Discriminator, init_hifigan

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    flags = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    dev = torch.device("cuda")
    d = init_hifigan(Discriminator(), torch.Generator().manual_seed(1)).to(dev)
    x = torch.randn(16, 32000, generator=torch.Generator().manual_seed(3)).mul(0.1).to(dev)
    pooled = [x]
    for _ in range(2):
        pooled.append(torch.nn.functional.avg_pool1d(pooled[-1][:, None], 4, 2, padding=2,
                                                     count_include_pad=True)[:, 0])

    def fwd_bwd(pairs):
        def run():
            d.zero_grad(set_to_none=True)
            sum(sub(h)[0].square().mean() for sub, h in pairs).backward()
        return run

    groups = {"mpd": fwd_bwd([(sub, x) for sub in d.mpd]), "msd": fwd_bwd(list(zip(d.msd, pooled)))}
    times = {}
    try:
        with f32_precision("highest"):
            for setting in settings:
                torch.use_deterministic_algorithms(setting == "deterministic")
                torch.backends.cudnn.deterministic = setting == "deterministic"
                torch.backends.cudnn.benchmark = setting == "autotuned"
                for name, fn in groups.items():
                    times.setdefault(f"{name} {setting}", []).append(time_ms(torch, fn, 5))
    finally:
        torch.use_deterministic_algorithms(flags[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags[1:]
    del d, x, pooled
    torch.cuda.empty_cache()
    log(f"[train] {gpu_line()}: discriminators' forward + backward at 16 x 2 s, TF32 off, ms (settings in "
        f"turns): " + json.dumps(times))
    return times


def informative_smoke_model(torch):
    """The trainer's --smoke codec (seed 0) with the latent projection scaled
    x30 to a unit-variance latent, so its codes span the FSQ levels: at the
    raw init scale every code is the zero level and the log-spectral loss's
    gradient is f32 rounding noise (tests/torch_port.py)."""
    from simwhisper_codec_tpu_torch.experiments.codec.train import SMOKE
    from simwhisper_codec_tpu_torch.models.codec import init_params

    model = init_params(SMOKE, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.downsample.to_latent.weight.mul_(30.0)
    return model


def card_vs_cpu_check(torch) -> None:
    """One codec GAN step at --smoke width (batch 2 x 0.5 s) on the CPU and on
    the card from the same state, TF32 off (the CPU replaying the card's
    leaky-ReLU branches), under ``aot.eager()``: losses within rtol 1e-4,
    every gradient (codec and discriminator) within GRAD_TOL; the card's step
    twice from the same state gives equal bits (deterministic kernels, no
    hand kernel launched)."""
    import copy

    from simwhisper_codec_tpu_torch.experiments.codec.train import SMOKE, segment_mel, set_determinism
    from simwhisper_codec_tpu_torch.models.codec import f32_precision
    from simwhisper_codec_tpu_torch.models import hifigan
    from simwhisper_codec_tpu_torch.models.hifigan import Discriminator, init_hifigan, lrelu
    from simwhisper_codec_tpu_torch.ops import _cuda
    from simwhisper_codec_tpu_torch.ops.mel import log_mel
    from simwhisper_codec_tpu_torch.train.codec_gan import codec_gan_step, init_codec_gan_state
    from simwhisper_codec_tpu_torch.train.gan import make_mel_loss_constants
    from simwhisper_codec_tpu_torch.utils import aot

    set_determinism()
    model = informative_smoke_model(torch)
    disc = init_hifigan(Discriminator(), torch.Generator().manual_seed(1))
    branches, flips = [], [0, 0]

    def recording_lrelu(x, slope):
        keep = x >= 0
        branches.append(keep.cpu())
        return torch.where(keep, x, slope * x)

    def replaying_lrelu(x, slope):
        keep = branches.pop(0).to(x.device)
        flips[0] += int((keep != (x >= 0)).sum())
        flips[1] += keep.numel()
        return torch.where(keep, x, slope * x)
    audio = torch.from_numpy(np.stack([voice(np.random.default_rng(s), 0.5, 16000) for s in (1, 2)]))
    with torch.no_grad(), f32_precision("highest"):
        mel = log_mel(segment_mel(SMOKE, audio.shape[1]), audio)

    def step(device):
        state = init_codec_gan_state(copy.deepcopy(model).to(device), copy.deepcopy(disc).to(device))
        batch = {"mel": mel.to(device), "audio": audio.to(device),
                 "mel_lens": torch.full((2,), mel.shape[1], dtype=torch.int64, device=device)}
        # eagerly: the gradients are read after the step, and the leaky ReLU's
        # branches are recorded in Python (a capture would run it twice)
        with aot.eager():
            metrics = codec_gan_step(state, batch, make_mel_loss_constants().to(device))
        grads = {f"codec.{k}": p.grad.cpu() for k, p in state.model.named_parameters() if p.grad is not None}
        grads.update({f"disc.{k}": p.grad.cpu() for k, p in state.discriminator.named_parameters()})
        return metrics, grads

    # A leaky ReLU's gradient jumps at 0, so a pre-activation within f32
    # rounding of 0 can take the other branch on the other device and move a
    # bias gradient by ~3e-3 of its tensor's max by itself.  The CPU step
    # therefore replays the card's branch decisions, in call order, and the
    # count of decisions it would have taken otherwise is reported.
    _cuda.reset_launch_counts()
    gpu_m, gpu_g = step(torch.device("cuda"))
    again_m, again_g = step(torch.device("cuda"))
    assert not _cuda.launch_counts, f"the training step launched hand kernels: {_cuda.launch_counts}"
    hifigan.lrelu = recording_lrelu
    try:
        rec_m, _ = step(torch.device("cuda"))
        hifigan.lrelu = replaying_lrelu
        cpu_m, cpu_g = step(torch.device("cpu"))
    finally:
        hifigan.lrelu = lrelu
    assert rec_m == gpu_m and not branches, "the replayed branches do not match the step's calls"
    assert gpu_m == again_m and all(torch.equal(gpu_g[k], again_g[k]) for k in gpu_g), \
        "the card's step is not deterministic"
    for k in LOSS_KEYS:
        assert abs(gpu_m[k] - cpu_m[k]) <= 1e-4 * abs(cpu_m[k]), (k, gpu_m[k], cpu_m[k])
    errs = {k: float((gpu_g[k] - cpu_g[k]).abs().max()) / max(float(cpu_g[k].abs().max()), 1e-4) for k in cpu_g}
    worst = max(errs, key=errs.get)
    log(f"[train] card vs CPU, one GAN step at --smoke width, TF32 off: losses {json.dumps(gpu_m)} vs "
        f"{json.dumps(cpu_m)} (rtol 1e-4); worst gradient {worst} {errs[worst]:.3g} over {len(errs)} tensors "
        f"(tolerance {GRAD_TOL}); the CPU replayed the card's leaky-ReLU branches, {flips[0]} of {flips[1]} "
        f"differing from its own; the card's step repeated bit for bit; no hand kernel launched")
    if errs[worst] > GRAD_TOL:
        raise AssertionError(f"gradient {worst} differs between the card and the CPU by {errs[worst]:.3g}")


def dp_codec_check(torch, out: str) -> None:
    """Run by every rank of a torchrun group: ``AudioCodec(data_parallel=True)``
    against ``AudioCodec()`` at --smoke width (parity, the card) on three
    utterances (a batch of 3 padded to a multiple of the world size)."""
    import copy

    from simwhisper_codec_tpu_torch.experiments.codec.train import SMOKE, set_determinism
    from simwhisper_codec_tpu_torch.models.codec import AudioCodec
    from simwhisper_codec_tpu_torch.parallel import dist

    set_determinism()
    ctx = dist.init_from_env(torch.device("cuda"))
    device = dist.local_device(ctx, torch.device("cuda"))
    model = informative_smoke_model(torch)
    rng = np.random.default_rng(1)
    wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in (40000, 33000, 21000)]
    single = AudioCodec(SMOKE, copy.deepcopy(model), device=device)
    dpc = AudioCodec(SMOKE, copy.deepcopy(model), device=device, data_parallel=True)
    enc_s, enc_d = single.encode(wavs)["codes_list"], dpc.encode(wavs)["codes_list"]
    dec_s, dec_d = single.decode(enc_s)["syn_wav_list"], dpc.decode(enc_s)["syn_wav_list"]
    if ctx.rank == 0:
        Path(out).write_text(json.dumps({
            "world_size": ctx.world_size, "codes_equal": all(np.array_equal(a, b) for a, b in zip(enc_s, enc_d)),
            "waves_equal": all(np.array_equal(a, b) for a, b in zip(dec_s, dec_d)),
            "wave_max_abs_diff": max(float(np.abs(a - b).max()) for a, b in zip(dec_s, dec_d))}))
    torch.distributed.destroy_process_group()


def dp_worker(torch, work: Path) -> None:
    """One rank of ``dp_phase``'s torchrun group: rank 0 first runs the trainer
    (--smoke, batch 4, 3 steps) without --data_parallel, then every rank runs
    it with --data_parallel, then ``dp_codec_check``."""
    from simwhisper_codec_tpu_torch.experiments.codec.train import main as train_main
    from simwhisper_codec_tpu_torch.parallel import dist

    dist.init_from_env(torch.device("cuda"))  # the group outlives both trainer runs
    common = ["--smoke", "--device", "cuda", "--steps", "3", "--log_every", "1", "--batch_size", "4", "--seed", "3"]
    if int(os.environ["RANK"]) == 0:
        train_main(common + ["--output_folder", str(work / "single")])
    train_main(common + ["--data_parallel", "--output_folder", str(work / "dp")])
    dp_codec_check(torch, str(work / "codec.json"))


def dp_phase(torch, n_gpus: int, work: Path) -> None:
    """``dp_worker`` over ``n_gpus`` ranks (torchrun, NCCL).  One rank: every
    loss and the codec's codes and waveforms bit-equal to the runs without
    DP; more: losses within rtol 1e-4, codes equal, waveforms within 1e-5."""
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = start(["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(n_gpus), __file__,
                  "--check", "dp", "--work_dir", str(work)], work / "dp.log")
    finish("DP workers", proc, work / "dp.log", 600)
    log_s, log_d = train_log(work / "single"), train_log(work / "dp")
    assert [r["step"] for r in log_s] == [r["step"] for r in log_d] == [1, 2, 3]
    for rows in (log_s, log_d):  # the DP step's all-reduce is captured over NCCL
        assert [r["program"] for r in rows] == ["captured", "replayed", "replayed"], rows
    worst = max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-12) for a, b in zip(log_s, log_d) for k in LOSS_KEYS)
    res = json.loads((work / "codec.json").read_text())
    assert res["world_size"] == n_gpus and res["codes_equal"], res
    if n_gpus == 1:
        assert worst == 0.0 and res["waves_equal"], (worst, res)
    else:
        assert worst <= 1e-4 and res["wave_max_abs_diff"] <= 1e-5, (worst, res)
    log(f"[train] {gpu_line()} (x{torch.cuda.device_count()}): DP over {n_gpus} GPU(s) (NCCL, torchrun): "
        f"trainer losses at steps 1-3 (step 1 captured, 2-3 replayed) worst relative difference "
        f"{worst:.3g} against one process; AudioCodec(data_parallel=True) codes equal, waveforms "
        f"{'bit-equal' if res['waves_equal'] else 'max |d| ' + format(res['wave_max_abs_diff'], '.3g')} "
        f"({time.perf_counter() - t0:.1f} s)")


GRAPH_STEPS = 6  # codec GAN steps of --check train-graph; the state goes through host memory after step 2
GRAPH_RELOAD = 2
GRAPH_CODEC_BATCH = (16, 2.0)  # the trainer's batch: 16 crops of 2 s
GRAPH_RECIPE_BATCH = (32, 28)  # the recipe's: 32 segments of 28 feature frames (8960 samples)


def host_copy(torch, x):
    """A nested state with every tensor cloned to the host."""
    if isinstance(x, dict):
        return {k: host_copy(torch, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(host_copy(torch, v) for v in x)
    return x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x


def first_difference(torch, a, b, where: str = "state") -> str:
    """The first place two nested states differ in a bit, or ""."""
    if isinstance(a, dict):
        if set(a) != set(b):
            return f"{where} (keys)"
        return next((d for k in a if (d := first_difference(torch, a[k], b[k], f"{where}.{k}"))), "")
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return f"{where} (length)"
        return next((d for i, (u, v) in enumerate(zip(a, b)) if (d := first_difference(torch, u, v, f"{where}[{i}]"))),
                    "")
    if isinstance(a, torch.Tensor):
        return "" if a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b) else where
    return "" if a == b else where


def graph_run(torch, make_state, program_of, step, batches, eager: bool, after_step=None, reload_after=None) -> tuple:
    """``step(state, batch)`` over ``batches`` from a fresh ``make_state()``,
    through its program (captured at the first step) or under
    ``aot.eager()``; after the step numbered ``reload_after`` the state goes
    through host memory and back, as a resume loads it (the load drops the
    program's graphs).  Returns the run's record (losses, ms a step, how each
    step ran, warm-up and capture ms of each capture, peak memory) and the
    final state on the host."""
    import gc

    from simwhisper_codec_tpu_torch.utils import aot

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    state = make_state()
    program = program_of(state)
    run = {"losses": [], "ms": [], "programs": [], "captures": []}
    with aot.eager() if eager else contextlib.nullcontext():
        for i, batch in enumerate(batches, start=1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run["losses"].append(step(state, batch))  # floats: the step has finished
            torch.cuda.synchronize()
            run["ms"].append((time.perf_counter() - t0) * 1e3)
            run["programs"].append(program.source)
            if program.source == "captured":
                run["captures"].append((program.warm_ms, program.capture_ms))
            if after_step is not None:
                after_step(state)
            if i == reload_after:
                state.load_state_dict(host_copy(torch, state.state_dict()))
    run["peak"] = torch.cuda.max_memory_allocated(dev)
    final = host_copy(torch, state.state_dict())
    del state, program
    gc.collect()
    torch.cuda.empty_cache()
    return run, final


def graph_pair_line(name: str, eager: dict, graph: dict, timed) -> str:
    """Eager and replayed ms a step over the steps ``timed`` (1-based), each capture's ms, peak memory."""
    each = {k: [r["ms"][i - 1] for i in timed] for k, r in (("eager", eager), ("graph", graph))}
    listed = {k: ", ".join(f"{v:.1f}" for v in vals) for k, vals in each.items()}
    captures = "; ".join(f"warm-up step {w:.1f} ms, capture {c:.1f} ms" for w, c in graph["captures"])
    return (f"{name}: eager {np.mean(each['eager']):.1f} ms a step, replayed {np.mean(each['graph']):.1f} (steps "
            f"{', '.join(map(str, timed))}: eager {listed['eager']}; replayed {listed['graph']}); captures: "
            f"{captures}; peak max_memory_allocated eager {eager['peak'] / 1e9:.2f} GB, captured "
            f"{graph['peak'] / 1e9:.2f} GB")


def train_graph_check(torch) -> None:
    """``--check train-graph`` (a child with deterministic kernels): the
    training steps as CUDA graphs against ``aot.eager()``, bit for bit.
    (1) ``GRAPH_STEPS`` full-width codec GAN steps (``CodecConfig()``, seed 0,
    batch 16 x 2 s of voices, lr 2e-4): step 1 warms up and captures, the
    state goes through host memory after step 2 (the load drops the graphs:
    step 3 captures again), the rest replay; the eager run does the same
    load.  (2) The recipe's three epochs (``HifiGanConfig(768, 512)``, batch
    32 x 8960, random features, one step an epoch, the rate decayed after
    each): epoch 1 captures, epochs 2-3 replay with the decayed rate.  Each:
    the losses, both models' parameters and spectral-norm vectors, both
    optimizers' moments, steps and rates equal bit for bit; eager and
    replayed ms a step, warm-up and capture ms, peak memory."""
    import copy

    from simwhisper_codec_tpu_torch.config import CodecConfig
    from simwhisper_codec_tpu_torch.experiments.codec.train import segment_log_mel, segment_mel, set_determinism
    from simwhisper_codec_tpu_torch.models.codec import init_params
    from simwhisper_codec_tpu_torch.models.hifigan import Discriminator, Generator, HifiGanConfig, init_hifigan
    from simwhisper_codec_tpu_torch.train.codec_gan import codec_gan_program, codec_gan_step, init_codec_gan_state
    from simwhisper_codec_tpu_torch.train.gan import (
        GanTrainState,
        decay_learning_rate,
        gan_program,
        gan_train_step,
        make_gan_optimizers,
        make_mel_loss_constants,
    )

    set_determinism()
    dev = torch.device("cuda")
    gpu = gpu_line()
    mel_consts = make_mel_loss_constants().to(dev)

    cfg = CodecConfig()
    model, disc = init_params(cfg, torch.Generator().manual_seed(0)), init_hifigan(
        Discriminator(), torch.Generator().manual_seed(1))
    rows, seconds = GRAPH_CODEC_BATCH
    seg = segment_mel(cfg, int(seconds * 16000)).to(dev)
    rng = np.random.default_rng(23)
    batches = []
    for _ in range(GRAPH_STEPS):
        audio = torch.from_numpy(np.stack([voice(rng, seconds, 16000) for _ in range(rows)])).to(dev)
        mel = segment_log_mel(seg, audio)["mel"]
        batches.append({"mel": mel, "audio": audio,
                        "mel_lens": torch.full((rows,), mel.shape[1], dtype=torch.int64, device=dev)})
    codec = dict(make_state=lambda: init_codec_gan_state(copy.deepcopy(model).to(dev), copy.deepcopy(disc).to(dev)),
                 program_of=lambda st: codec_gan_program(st, mel_consts),
                 step=lambda st, b: codec_gan_step(st, b, mel_consts), batches=batches, reload_after=GRAPH_RELOAD)
    eager, eager_state = graph_run(torch, eager=True, **codec)
    graph, graph_state = graph_run(torch, eager=False, **codec)
    assert graph["programs"] == ["captured", "replayed", "captured"] + ["replayed"] * (GRAPH_STEPS - 3), \
        graph["programs"]
    assert eager["programs"] == ["eager"] * GRAPH_STEPS, eager["programs"]
    assert graph["losses"] == eager["losses"], (graph["losses"], eager["losses"])
    diff = first_difference(torch, graph_state, eager_state)
    assert not diff, f"the captured codec GAN steps differ from the eager ones at {diff}"
    assert all(np.isfinite(v) for r in graph["losses"] for v in r.values()), graph["losses"]
    log(f"[train-graph] {gpu}: {GRAPH_STEPS} full-width codec GAN steps (CodecConfig(), batch {rows} x {seconds:g} s) "
        f"captured "
        f"(step 1; again at step {GRAPH_RELOAD + 1} after the state went through host memory) and replayed, "
        f"against aot.eager(): losses, parameters, spectral-norm vectors, both optimizers' moments, steps and "
        f"rates bit for bit; " + graph_pair_line("codec GAN step", eager, graph, range(4, GRAPH_STEPS + 1)))
    del model, disc, batches, eager_state, graph_state, codec

    gcfg = HifiGanConfig(in_channels=768, upsample_initial_channel=512)
    gen0 = init_hifigan(Generator(gcfg), torch.Generator().manual_seed(0))
    disc0 = init_hifigan(Discriminator(), torch.Generator().manual_seed(1))
    rng = np.random.default_rng(24)
    rows, frames = GRAPH_RECIPE_BATCH
    batches = [{"features": torch.from_numpy(rng.standard_normal((rows, frames, gcfg.in_channels))
                                             .astype(np.float32)).to(dev),
                "audio": torch.from_numpy(np.stack([voice(rng, frames * 0.02, 16000) for _ in range(rows)])).to(dev)}
               for _ in range(RECIPE_EPOCHS)]
    rates = {True: [], False: []}

    def make_recipe_state():
        g, d = copy.deepcopy(gen0).to(dev), copy.deepcopy(disc0).to(dev)
        return GanTrainState(g, d, *make_gan_optimizers(g, d, 2e-4))

    def decay(eager_run):
        def after(st):
            decay_learning_rate(st, 0.9999)
            rates[eager_run].append([float(opt.param_groups[0]["lr"]) for opt in (st.g_opt, st.d_opt)])
        return after

    recipe = dict(make_state=make_recipe_state, program_of=lambda st: gan_program(st, mel_consts),
                  step=lambda st, b: gan_train_step(st, b, mel_consts), batches=batches)
    eager, eager_state = graph_run(torch, eager=True, after_step=decay(True), **recipe)
    graph, graph_state = graph_run(torch, eager=False, after_step=decay(False), **recipe)
    assert graph["programs"] == ["captured"] + ["replayed"] * (RECIPE_EPOCHS - 1), graph["programs"]
    want = [[float(f32_rate(e))] * 2 for e in range(1, RECIPE_EPOCHS + 1)]
    assert rates[True] == rates[False] == want, (rates, want)
    assert graph["losses"] == eager["losses"], (graph["losses"], eager["losses"])
    diff = first_difference(torch, graph_state, eager_state)
    assert not diff, f"the captured recipe steps differ from the eager ones at {diff}"
    log(f"[train-graph] {gpu}: the recipe's {RECIPE_EPOCHS} epochs (HifiGanConfig(768, 512), batch {rows} x "
        f"{frames * 320}, one step an epoch) captured at epoch 1 and replayed with each epoch's rate 2e-4 * 0.9999^e "
        f"({', '.join(repr(r[0]) for r in want)}), against aot.eager(): losses and state bit for bit; "
        + graph_pair_line("recipe step", eager, graph, tuple(range(2, RECIPE_EPOCHS + 1))))


# -- phase 6: the variant modules and the HiFi-GAN continuation recipe --------

RECIPE = "simwhisper_codec_tpu_torch.experiments.hifigan_continue.train"
EXTRACT = "simwhisper_codec_tpu_torch.experiments.hifigan_continue.extract_features"
VARIANT_TOL = 1e-4  # kernel vs dense and card vs CPU: max |d| <= TOL * max(max |ref|, 1)
HIDDEN_SECONDS = (30, 26, 21, 17, 12, 8, 4, 1)  # one utterance in each 30 s window of the batch
RECIPE_VOICES = 40  # 1-3 s each; the 80/10/10 split leaves 32 training utterances, one batch of 32
RECIPE_EPOCHS = 3


def rel_err(torch, got, want, where=None) -> float:
    """max |got - want| over max(max |want|, 1), on ``where`` if given (float64,
    on the tensors' device)."""
    d, w = (got.double() - want.double()).abs(), want.double().abs()
    if where is not None:
        d, w = d[where], w[where]
    return float(d.max()) / max(float(w.max()), 1.0)


def linear_mag(torch, log_mag):
    """|X| from ``stft_log_mag_phase``'s log(|X| + 1e-5), in float64."""
    return torch.exp(log_mag.double()) - 1e-5


def wrapped_phase_diff(a, b):
    """|a - b| wrapped into [0, pi], in float64."""
    return ((a.double() - b.double() + np.pi).remainder(2 * np.pi) - np.pi).abs()


def random_encoder(torch, cfg):
    from simwhisper_codec_tpu_torch.models.transformer import Encoder, init_transformer

    enc = Encoder(cfg)
    init_transformer(enc, torch.Generator().manual_seed(0))
    return enc.eval()


def hidden_states_check(torch) -> dict:
    """``Encoder(output_hidden_states=True)`` at ``EncoderConfig()`` (12 x 768,
    random weights, seed 0) on 8 x 30 s windows, TF32 off: ``pflash`` and
    ``flash`` (the f32 B1 / B5 kernels, launch counts read around each run)
    against ``dense`` on all 13 states; then the semantic encoder
    (``is_acoustic=False``) on one 30 s utterance, card against CPU.
    Returns the launches by run."""
    from simwhisper_codec_tpu_torch.config import EncoderConfig, FeatureExtractorConfig
    from simwhisper_codec_tpu_torch.models.codec import f32_precision
    from simwhisper_codec_tpu_torch.ops import _cuda
    from simwhisper_codec_tpu_torch.ops.mel import MelConstants, log_mel, mel_lengths
    from simwhisper_codec_tpu_torch.utils import aot

    dev = torch.device("cuda")
    cfg, fe = EncoderConfig(), FeatureExtractorConfig()
    rng = np.random.default_rng(12)
    wav = np.zeros((len(HIDDEN_SECONDS), fe.n_samples), np.float32)
    for i, s in enumerate(HIDDEN_SECONDS):
        wav[i, : s * fe.sampling_rate] = voice(rng, s, fe.sampling_rate)
    consts = MelConstants(fe).to(dev)
    enc = random_encoder(torch, cfg).to(dev)
    out, launches, ms = {}, {}, {}
    with torch.no_grad(), f32_precision("highest"):
        mel = log_mel(consts, torch.from_numpy(wav).to(dev))
        lens = mel_lengths(torch.tensor([s * fe.sampling_rate for s in HIDDEN_SECONDS], device=dev),
                           fe.hop_length, consts.n_frames)
        for impl in ("dense", "pflash", "flash"):
            def run(impl=impl):
                return enc(mel, lens, attn_impl=impl, output_hidden_states=True)
            _cuda.reset_launch_counts()
            out[impl] = run()
            torch.cuda.synchronize()
            launches[f"hidden-{impl}"] = dict(_cuda.launch_counts)
            ms[impl] = time_ms(torch, run, 3)
        # each impl's states as a CUDA graph (utils/aot.py; one 8 x 30 s signature), a replay against eager
        graphs = {}
        for impl in ("dense", "pflash", "flash"):
            program = aot.CapturedProgram(lambda m, n, impl=impl: {"states": enc(m, n, attn_impl=impl,
                                                                                  output_hidden_states=True)[2]},
                                          f"hidden-{impl}")
            program(mel, lens)
            replay = program(mel, lens)["states"]
            assert program.count == 1 and program.source == "replayed", (impl, program.count, program.source)
            graphs[impl] = {"replay_vs_eager": rel_err(torch, replay, out[impl][2]),
                            "bit_for_bit": bool(torch.equal(replay, out[impl][2])),
                            "ms": time_ms(torch, lambda: program(mel, lens), 3), "eager_ms": ms[impl]}
            del program, replay
        final, out_lens, states = out["dense"]
        assert states.shape == (cfg.encoder_layers + 1, len(HIDDEN_SECONDS), 1500, cfg.d_model), states.shape
        assert torch.equal(states[-1], final) and bool(torch.isfinite(states).all())
        errs = {impl: rel_err(torch, out[impl][2], states) for impl in ("pflash", "flash")}
        errs.update({f"{impl} graph vs eager": g["replay_vs_eager"] for impl, g in graphs.items()})
        want = {"hidden-dense": {}, "hidden-pflash": {"pflash_attention_f32": cfg.encoder_layers},
                "hidden-flash": {"flash_attention_f32": cfg.encoder_layers}}
        assert launches == want, f"hidden-state launches {launches} != expected {want}"
        del out, final, states
        sem = random_encoder(torch, EncoderConfig(is_acoustic=False))
        _, _, sem_cpu = sem(mel[:1].cpu(), lens[:1].cpu(), output_hidden_states=True)
        sem = sem.to(dev)
        _, _, sem_card = sem(mel[:1], lens[:1], output_hidden_states=True)
        errs["semantic"] = rel_err(torch, sem_card.cpu(), sem_cpu)
        ms["semantic, 1 x 30 s"] = time_ms(torch, lambda: sem(mel[:1], lens[:1], output_hidden_states=True), 3)
    log(f"[variants] {gpu_line()}: encoder hidden states at EncoderConfig() (12 x 768, random weights), "
        f"8 x 30 s windows (utterances of {', '.join(map(str, HIDDEN_SECONDS))} s), TF32 off: ms a call "
        f"{json.dumps(ms)}; 13 states, max |d| / max(max |dense|, 1): {json.dumps(errs)} (tolerance "
        f"{VARIANT_TOL}; semantic = card vs CPU); launches {json.dumps(launches)}; as CUDA graphs, ms a call "
        f"(CUDA events) and replay vs eager: {json.dumps(graphs)}")
    bad = {k: v for k, v in errs.items() if not v <= VARIANT_TOL}
    if bad:
        raise AssertionError(f"hidden states out of tolerance: {bad}")
    return launches


def extractor_program_check(torch) -> dict:
    """The recipe's extractors' programs (``program_check``) at full width,
    random weights: ``FeatureExtractor`` at ``EncoderConfig()`` (its one 30 s
    window; utterances of 12 s and 27 s) and ``HubertFeatureExtractor`` at
    ``hubert_base_config()`` (2.5 s and 3.5 s: the 4 s bucket)."""
    from simwhisper_codec_tpu_torch.config import EncoderConfig
    from simwhisper_codec_tpu_torch.experiments.hifigan_continue.extract_features import (
        FeatureExtractor,
        HubertFeatureExtractor,
    )

    rng = np.random.default_rng(15)
    whisper = FeatureExtractor(EncoderConfig(), random_encoder(torch, EncoderConfig()), device="cuda")
    hubert = HubertFeatureExtractor(allow_random=True, device="cuda")
    out = {"hidden_states": program_check(torch, "hidden_states", whisper, whisper.extract,
                                          [voice(rng, s, 16000) for s in (12.0, 27.0)]),
           "hubert": program_check(torch, "hubert_features", hubert, hubert.extract,
                                   [voice(rng, s, 16000) for s in (2.5, 3.5)])}
    log(f"[variants] {gpu_line()}: the recipe's extractors as CUDA graphs (utils/aot.py), full width, random "
        f"weights, TF32 off, against aot.eager() (tolerance {TOWER_TOL}): {json.dumps(out)}")
    return out


def variants_check(torch) -> None:
    """The Vocos variants at the production widths (backbone 80 -> 512, 3
    blocks; both IMDCT heads at dim 512, frame 320) on (8, 3000, 80), the STFT
    (n_fft 640, hop 160, both ``center``; its magnitude) and an MDCT -> IMDCT
    round trip on 8 x 30 s voices: card against CPU, TF32 off.  The STFT's
    log-magnitude and phase (the latter where the magnitude exceeds 1e-3) are
    held to float64 instead: the card's error no more than twice the CPU's."""
    from simwhisper_codec_tpu_torch.models.codec import f32_precision
    from simwhisper_codec_tpu_torch.models.vocos_variants import IMDCTCosHead, IMDCTSymExpHead, VocosResNetBackbone
    from simwhisper_codec_tpu_torch.ops import stft

    dev = torch.device("cuda")
    torch.manual_seed(0)
    backbone = VocosResNetBackbone(80, 512, 3)
    heads = {"imdct_symexp_head": IMDCTSymExpHead(512, 320), "imdct_cos_head": IMDCTCosHead(512, 320)}
    x = torch.randn(8, 3000, 80, generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(13)
    audio = torch.from_numpy(np.stack([voice(rng, 30.0, 16000) for _ in range(8)]))
    errs, ms, vs_f64 = {}, {}, {}

    def card_vs_cpu(name, fn, module, *args):
        """fn(module, *args) on the CPU, then on the card; returns (card's on the CPU, CPU's)."""
        want = fn(module.cpu(), *args)
        module.to(dev)
        dev_args = [a.to(dev) for a in args]
        got = fn(module, *dev_args)
        ms[name] = time_ms(torch, lambda: fn(module, *dev_args), 5)
        return got.cpu() if isinstance(got, torch.Tensor) else [g.cpu() for g in got], want

    with torch.no_grad(), f32_precision("highest"):
        got, h = card_vs_cpu("resnet_backbone", lambda m, a: m(a), backbone, x)
        errs["resnet_backbone"] = rel_err(torch, got, h)
        for name, head in heads.items():
            got, want = card_vs_cpu(name, lambda m, a: m(a), head, h)
            assert got.shape == (8, 480000), got.shape
            errs[name] = rel_err(torch, got, want)
        for center in (True, False):
            consts = stft.make_stft_constants(640, 160, 640, center)
            (mag, phase), (mag_ref, phase_ref) = card_vs_cpu(
                f"stft center={center}", stft.stft_log_mag_phase, consts, audio)
            mag64, phase64 = stft.stft_log_mag_phase(stft.make_stft_constants(640, 160, 640, center).double(),
                                                     audio.double())
            errs[f"stft center={center} |X|"] = rel_err(torch, linear_mag(torch, mag), linear_mag(torch, mag_ref))
            # log and atan2 amplify the f32 DFT's absolute error (~1e-5) where
            # |X| is small: each device's log-magnitude (all bins) and phase
            # (|X| > 1e-3) against float64, the card's no worse than 2x the CPU's
            sure = linear_mag(torch, mag64) > 1e-3
            for name, card, cpu, exact, where, diff in (
                    ("log_mag", mag, mag_ref, mag64, None, lambda a, b: (a.double() - b).abs()),
                    ("phase", phase, phase_ref, phase64, sure, wrapped_phase_diff)):
                e_card, e_cpu = (float(diff(x, exact)[where].max() if where is not None else diff(x, exact).max())
                                 for x in (card, cpu))
                vs_f64[f"stft center={center} {name}"] = {"card": e_card, "cpu": e_cpu}
            vs_f64[f"stft center={center} phase"]["share compared"] = float(sure.double().mean())
        consts = stft.make_mdct_constants(320)
        coeffs, coeffs_ref = card_vs_cpu("mdct", stft.mdct, consts, audio)
        recon, recon_ref = card_vs_cpu("imdct", stft.imdct, consts, coeffs_ref)
        errs["mdct"] = rel_err(torch, coeffs, coeffs_ref)
        errs["imdct"] = rel_err(torch, recon, recon_ref)
        errs["round trip vs audio (edges of 160 cut)"] = rel_err(torch, recon[:, 160:-160], audio[:, 160:-160])
    log(f"[variants] {gpu_line()}: card vs CPU, TF32 off, max |d| / max(max |CPU|, 1): {json.dumps(errs)} "
        f"(tolerance {VARIANT_TOL}); STFT max |d| against float64 on the CPU, card and CPU: {json.dumps(vs_f64)} "
        f"(the card's within 2x the CPU's); card ms a call: {json.dumps(ms)}")
    bad = {k: v for k, v in errs.items() if not v <= VARIANT_TOL}
    bad.update({k: v for k, v in vs_f64.items() if not v["card"] <= 2 * v["cpu"]})
    if bad:
        raise AssertionError(f"variants out of tolerance: {bad}")


def generator_check(torch) -> None:
    """One ``Generator(HifiGanConfig())`` forward (768 -> 512 channels, seed 0)
    on 8 x 50 feature frames, card against CPU, TF32 off.  The weight-norm
    gains are scaled to unit-gain convolutions (std 1 / sqrt(fan-in)): at the
    recipe's init (v ~ N(0, 0.01^2)) the output is ~1e-5 and the bound,
    relative to max(max |ref|, 1), could not fail."""
    from simwhisper_codec_tpu_torch.models.codec import f32_precision
    from simwhisper_codec_tpu_torch.models.hifigan import Generator, HifiGanConfig, WNConvTranspose1d, init_hifigan

    dev = torch.device("cuda")
    gen = init_hifigan(Generator(HifiGanConfig()), torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in gen.modules():
            if hasattr(m, "g"):  # (O, I, K) convs; (I, O, K) transposed convs
                fan_in = m.v.shape[0 if isinstance(m, WNConvTranspose1d) else 1] * m.v.shape[2]
                m.g.mul_(1.0 / (0.01 * fan_in ** 0.5))
    feats = torch.randn(8, 50, 768, generator=torch.Generator().manual_seed(2))
    with torch.no_grad(), f32_precision("highest"):
        want = gen(feats)
        gen.to(dev)
        dev_feats = feats.to(dev)
        got = gen(dev_feats).cpu()
        ms = time_ms(torch, lambda: gen(dev_feats), 5)
    err = rel_err(torch, got, want)
    log(f"[variants] HiFi-GAN Generator(HifiGanConfig()) on 8 x 50 frames -> {tuple(got.shape)} (max |y| "
        f"{float(want.abs().max()):.3f}): card vs CPU {err:.3g} (tolerance {VARIANT_TOL}), {ms:.3f} ms a call "
        f"on the card")
    if not (got.shape == (8, 16000) and err <= VARIANT_TOL):
        raise AssertionError(f"generator: shape {tuple(got.shape)}, card vs CPU {err}")


def recipe_log(folder: Path) -> str:
    return (folder / "train_log.txt").read_text()


def f32_rate(epochs: int) -> np.float32:
    """The recipe's rate after ``epochs`` decays: 2e-4 * 0.9999^e, each product
    rounded to f32 (the rate is an f32 tensor, as ``inject_hyperparams``' is)."""
    lr = np.float32(2e-4)
    for _ in range(epochs):
        lr = np.float32(lr * np.float32(0.9999))
    return lr


def check_features(folder: Path, n: int, frames) -> None:
    """``n`` finite [T, 1, 768] f32 feature files, T = frames(utterance id)."""
    files = sorted(folder.glob("*.npy"))
    assert len(files) == n, (folder, len(files))
    for f in files:
        a = np.load(f)
        assert a.dtype == np.float32 and a.shape == (frames(f.stem), 1, 768) and np.isfinite(a).all(), (f, a.shape)


def recipe_phase(torch) -> None:
    """The HiFi-GAN continuation recipe at full width, each run a child process
    with deterministic kernels: data prep of 40 synthetic voices (half WAV,
    half FLAC), Whisper-encoder features at ``EncoderConfig()`` and 3 epochs of
    ``HifiGanConfig(768, 512)`` at batch 32 x 8960 (one step an epoch); then,
    side by side, a fresh process resuming at epoch 4 from epoch 3's
    checkpoint and ``--feature_type hubert`` extraction at
    ``hubert_base_config()``; beside them the generator alone, card vs CPU."""
    from simwhisper_codec_tpu_torch.models.ssl import feat_extract_output_length, hubert_base_config
    from simwhisper_codec_tpu_torch.utils.audio_io import save_audio
    from simwhisper_codec_tpu_torch.utils.checkpoint import load_training_state, state_digest
    from simwhisper_codec_tpu_torch.utils.flac import write_flac

    sr = 16000
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        data, out = tmp / "wavs", tmp / "recipe"
        data.mkdir()
        rng = np.random.default_rng(14)
        samples = {}
        for i in range(RECIPE_VOICES):
            wav = voice(rng, rng.uniform(1.0, 3.0), sr)
            samples[f"v{i:02d}"] = len(wav)
            if i % 2:
                write_flac(data / f"v{i:02d}.flac", np.round(wav * 32767).astype(np.int64), sr)
            else:
                save_audio(data / f"v{i:02d}.wav", wav, sr)
        common = ["-m", RECIPE, "--data_folder", str(data), "--output_folder", str(out), "--allow_random",
                  "--seed", "0", "--keep_checkpoint_interval", "1", "--device", "cuda"]
        t0 = time.perf_counter()
        finish("recipe", start(common + ["--epochs", str(RECIPE_EPOCHS)], tmp / "recipe.log"), tmp / "recipe.log", 600)
        wall = time.perf_counter() - t0
        text = recipe_log(out)
        epochs = [re.search(rf"epoch {e}: g_loss=(\S+) batches=(\d+) time=\S+ step_ms=(\S+) "
                            rf"max_memory_allocated=(\d+) programs=(\S+)", text) for e in range(1, RECIPE_EPOCHS + 1)]
        assert all(m and m.group(2) == "1" and np.isfinite(float(m.group(1))) for m in epochs), text[-3000:]
        assert [m.group(5) for m in epochs] == ["captured"] + ["replayed"] * (RECIPE_EPOCHS - 1), text[-3000:]
        step_ms = [float(m.group(3)) for m in epochs]
        peak = max(int(m.group(4)) for m in epochs)
        manifests = {s: json.loads((out / "save" / f"{s}.json").read_text()) for s in ("train", "valid", "test")}
        assert [len(manifests[s]) for s in ("train", "valid", "test")] == [32, 4, 4], manifests
        mel_frames = lambda stem: -(-samples[stem] // 160) // 2  # noqa: E731
        check_features(out / "save" / "custom_features", 36, mel_frames)
        ckpts = sorted(p.name for p in (out / "checkpoints").glob("*.pt"))
        assert ckpts == [f"epoch_{e:04d}.pt" for e in range(1, RECIPE_EPOCHS + 1)], ckpts
        assert len(list((out / "samples").glob("epoch_*.wav"))) == RECIPE_EPOCHS
        timed = step_ms[1:]
        step = float(np.mean(timed))
        audio_s = 32 * 8960 / sr
        log(f"[recipe] {gpu_line()}: HiFi-GAN continuation at full width (Whisper-encoder features at "
            f"EncoderConfig(), random weights; HifiGanConfig(768, 512), batch 32 x 8960): {step:.1f} ms a step "
            f"replayed (steps 2-{RECIPE_EPOCHS}: {', '.join(f'{v:.1f}' for v in timed)}; step 1, the warm-up "
            f"step and the capture, {step_ms[0]:.1f}), "
            f"{audio_s / (step / 1e3):.2f} audio s trained a GPU s, peak max_memory_allocated {peak / 1e9:.2f} GB; "
            f"g_loss by epoch {[float(m.group(1)) for m in epochs]}; run {wall:.1f} s ("
            + "; ".join(re.sub(r"^\S+ \S+ ", "", line) for line in text.splitlines() if "ready in" in line) + ")")

        t0 = time.perf_counter()
        children = {
            "resume": (start(common + ["--resume", "--epochs", str(RECIPE_EPOCHS + 1)], tmp / "resume.log"),
                       tmp / "resume.log"),
            "hubert": (start(["-m", EXTRACT, "--manifest", str(out / "save" / "train.json"), "--out_dir",
                              str(tmp / "hubert"), "--feature_type", "hubert", "--allow_random", "--device", "cuda"],
                             tmp / "hubert.log"), tmp / "hubert.log"),
        }
        try:
            generator_check(torch)
            for name, (proc, path) in children.items():
                finish(name, proc, path, 600)
        finally:
            for proc, _ in children.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        side_wall = time.perf_counter() - t0
        last = f"epoch_{RECIPE_EPOCHS:04d}.pt"
        resumed = re.search(rf"resumed from {last} \(next epoch {RECIPE_EPOCHS + 1}, step (\d+), state digest (\w+)\)",
                            recipe_log(out))
        ckpt = load_training_state(str(out / "checkpoints" / last), map_location="cpu")
        lr = float(f32_rate(RECIPE_EPOCHS))
        assert resumed and int(resumed.group(1)) == ckpt["step"] == RECIPE_EPOCHS, resumed
        assert resumed.group(2) == state_digest(ckpt), "the resumed state differs from the checkpoint"
        del ckpt
        for e in range(1, RECIPE_EPOCHS + 1):  # each epoch's decayed rate, as the replays read it
            ckpt = load_training_state(str(out / "checkpoints" / f"epoch_{e:04d}.pt"), map_location="cpu")
            assert all(float(ckpt[k]["param_groups"][0]["lr"]) == float(f32_rate(e)) for k in ("g_opt", "d_opt")), e
            del ckpt
        assert re.search(rf"epoch {RECIPE_EPOCHS + 1}: g_loss=\S+ batches=1 .* programs=captured$", recipe_log(out),
                         re.M)
        hub = hubert_base_config()
        check_features(tmp / "hubert", 32, lambda stem: feat_extract_output_length(hub, samples[stem]))
        log(f"[recipe] each epoch's checkpoint holds the rate 2e-4 * 0.9999^e in f32; a fresh --resume process "
            f"restored epoch {RECIPE_EPOCHS}'s checkpoint bit for bit (G, D, both optimizers' moments and steps, "
            f"lr {lr!r}, step {RECIPE_EPOCHS}: equal state digests) and trained epoch {RECIPE_EPOCHS + 1} "
            f"(captured again); --feature_type hubert --allow_random wrote 32 finite [T, 1, 768] "
            f"features at hubert_base_config(); side by side {side_wall:.1f} s")


def variants_phase(torch) -> dict:
    """Phase 6; returns the hidden-state runs' launches."""
    t_phase = time.perf_counter()
    launches = hidden_states_check(torch)
    torch.cuda.empty_cache()
    extractor_program_check(torch)
    torch.cuda.empty_cache()
    variants_check(torch)
    torch.cuda.empty_cache()
    recipe_phase(torch)
    log(f"[variants] phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 8: tensor parallelism (parallel/mesh.py) ------------------------------

TP_CONFIG = "config/SimWhisperCodec.yaml"
# label -> (mode, attn_impl, vocos_impl) of each TP round trip; the chunked
# and packed runs' codes are also held to the one-process fast run's
TP_RUNS = {
    "parity": ("parity", None, None),
    "fast": ("fast", None, None),
    "fast-dw": ("fast", "flash", "fused-dw"),
    "fast-int8": ("fast-int8", None, None),
    "parity-pflash": ("parity", "pflash", None),
    "parity-flash": ("parity", "flash", None),
    "fast-chunked": ("fast", "chunked:1536:bf16", None),
    "fast-packed": ("fast", "packed:bf16", None),
}
TP_REFERENCE = {"fast-chunked": "fast", "fast-packed": "fast"}
TP_LENGTHS = (480000, 480000, 480000, 480000, 480000, 400000, 123457, 16000)
# The bf16 modes' codes move with any rounding change at full width on
# random weights (in one process on the H100, fast-dw's codes agree 0.946
# with fast's), and TP's f32 partial sums flip bf16 roundings too.  So a
# fast mode is held through its FSQ input (the compressed latent whose
# rounding gives the codes) and its waveform (decoded from one process's
# codes, so the decoder and Vocos alone differ): TP's max |d| from one
# process within TP_SWAP_FACTOR times the max |d| between two one-process
# programs that differ by a bf16 kernel swap, fast-dw (B5, B4) against fast
# (B1, B2): its encoder on the same audio, its decoder on fast's codes.  The
# code agreement also stays above the JAX package's floor for a bf16
# attention kernel's codes (tests/test_fast_mode.py:114).
TP_SWAP_FACTOR = 2.0
TP_FAST_AGREEMENT = 0.9
# Parity (f32): the FSQ input within TP_FSQ_TOL of one process's (it is
# O(1) a channel); a code then differs only where one process's value lies
# within that run's own f32 difference of a rounding boundary (measured on
# the H100: none of 24,000 with dense attention, at most one with the f32
# kernels); the waveform from one process's codes within
# TP_PARITY_WAVE_RTOL of its max |y|
TP_FSQ_TOL = 1e-4
TP_PARITY_AGREEMENT = 0.999
TP_PARITY_WAVE_RTOL = 1e-4
# One decoder layer and one Vocos block of each fast program on one input,
# sharded against whole: the outputs differ only where the f32 reordering
# of a sum crosses a rounding boundary, so the layer's update (output -
# input) is held on its mean |d|, mean |d| <= TP_LAYER_MEAN_RTOL mean
# |update|: a wrong partial (a bias twice, B3's row max of one rank) moves
# every row, where the round trips' chaos on random weights hides it.
TP_LAYER_RUNS = ("fast", "fast-dw", "fast-int8")
TP_LAYER_MEAN_RTOL = 1e-3


def tp_batch(cfg):
    """8 x 30 s of noise (seed 8), the last three rows shorter (ragged lengths)."""
    wav = np.random.default_rng(8).standard_normal((8, cfg.chunk_samples)).astype(np.float32) * 0.1
    lens = np.array(TP_LENGTHS, np.int64)
    wav[np.arange(cfg.chunk_samples)[None, :] >= lens[:, None]] = 0.0
    return wav, lens


def tp_masks(lens, n_samples: int) -> tuple:
    """(valid code frames (B, T_code), valid samples of the decoded waveform (B, n_samples))."""
    frames = np.arange(n_samples // 1280)[None, :] < lens[:, None] // 1280
    return frames, np.arange(n_samples)[None, :] < lens[:, None] // 1280 * 1280


def tp_model(torch, cfg):
    """Phase 3's full-width random weights (seed 0) on the CPU, the Vocos
    blocks' biases drawn N(0, 0.02^2) (seed 1; the init zeroes them, which
    would hide a bias added on every model rank), with the decoder's FFNs
    and the Vocos chains quantised whole (fast-int8's)."""
    from simwhisper_codec_tpu_torch.models.codec import init_params
    from simwhisper_codec_tpu_torch.ops.quant import quantize_stacked_convnext, quantize_stacked_ffn

    model = init_params(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for block in model.vocos.backbone.convnext:
            for conv in (block.dwconv, block.pwconv1, block.pwconv2):
                conv.bias.copy_(torch.randn(conv.bias.shape, generator=gen) * 0.02)
    quantize_stacked_ffn(model.acoustic_decoder.layers)
    quantize_stacked_convnext(model.vocos.backbone.convnext)
    return model.eval()


def tp_round_trip(torch, model, wav, lens, label, mesh=None, codes_in=None):
    """``tokenize`` + ``detokenize`` of the batch in run ``label``'s mode, on
    this data rank's rows and gathered under ``mesh``; the detokenize
    decodes ``codes_in`` (G, B, T_code) where given, else the tokenize's
    codes.  Returns codes, waveforms and FSQ inputs (numpy) and the host ms
    around the synchronised calls."""
    from simwhisper_codec_tpu_torch.models.codec import (
        detokenize,
        f32_precision,
        mode_deterministic,
        mode_programs,
        tokenize,
    )
    from simwhisper_codec_tpu_torch.ops.fsq import compress
    from simwhisper_codec_tpu_torch.parallel import mesh as pmesh

    mode, attn_impl, vocos_impl = TP_RUNS[label]
    tok_kw, detok_kw = mode_programs(mode, attn_impl, vocos_impl)
    rows = slice(None) if mesh is None else pmesh.batch_rows(mesh, len(wav))
    gather = (lambda t, dim=0: t) if mesh is None else (lambda t, dim=0: pmesh.gather_rows(mesh, t, dim))
    dev = next(model.parameters()).device
    w, n = torch.from_numpy(wav[rows]).to(dev), torch.from_numpy(lens[rows]).to(dev)
    given = None if codes_in is None else torch.from_numpy(codes_in).to(dev)
    latents = []  # the frame-stack's latent, the FSQ's input
    hook = model.downsample.register_forward_hook(lambda mod, args, out: latents.append(out[0]))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    try:
        with torch.no_grad(), f32_precision("highest" if mode == "parity" else "default", mode_deterministic(mode)):
            tok = tokenize(model, w, n, **tok_kw)
            codes, clen = gather(tok["codes"], 1), gather(tok["codes_lengths"])
            dec = codes if given is None else given
            y = gather(detokenize(model, dec[:, rows], clen[rows], dec.shape[-1], **detok_kw)["y"])
        torch.cuda.synchronize(dev)
    finally:
        hook.remove()
    ms = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        fsq_in = gather(compress(model.consts.fsq, latents[0].to(torch.float32)))
    return codes.cpu().numpy(), y.to(torch.float32).cpu().numpy(), fsq_in.cpu().numpy(), ms


# the TP runs also held as CUDA graphs over NCCL (``--tp_gpus``): between
# them every collective of the sharded programs (row-parallel out_proj and
# fc2, B2 / B3 / B4's partial sums, B3's row max)
TP_CAPTURE_RUNS = ("parity", "fast", "fast-dw", "fast-int8")


def tp_programs(shard, label: str) -> dict:
    """Run ``label``'s tokenize and detokenize on the shard as ``AudioCodec``
    builds them (``serving_program``, one pool), captured when the model
    group is NCCL's (``model_groups_capturable``)."""
    from simwhisper_codec_tpu_torch.models.codec import model_groups_capturable, serving_program
    from simwhisper_codec_tpu_torch.utils import aot

    mode, attn_impl, vocos_impl = TP_RUNS[label]
    pool, capture = aot.GraphPool(), model_groups_capturable(shard)
    return {d: serving_program(shard, mode, d, pool, attn_impl, vocos_impl, capture=capture)
            for d in ("tokenize", "detokenize")}


def tp_program_round_trip(torch, progs: dict, wav, lens, label, mesh, codes_in, dev):
    """``tp_round_trip`` through ``tp_programs``: this data rank's rows
    tokenized, one process's codes ``codes_in`` decoded (the chunk width a
    device int32), both gathered over the data axis outside the programs.
    Returns codes, waveforms (numpy) and the host ms around the
    synchronised calls."""
    from simwhisper_codec_tpu_torch.models.codec import f32_precision, mode_deterministic
    from simwhisper_codec_tpu_torch.parallel import mesh as pmesh

    mode = TP_RUNS[label][0]
    rows = pmesh.batch_rows(mesh, len(wav))
    w, n = torch.from_numpy(wav[rows]).to(dev), torch.from_numpy(lens[rows]).to(dev)
    given = torch.from_numpy(codes_in).to(dev)
    width = torch.full((), given.shape[-1], dtype=torch.int32, device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with torch.no_grad(), f32_precision("highest" if mode == "parity" else "default", mode_deterministic(mode)):
        tok = progs["tokenize"](w, n)
        codes, clen = pmesh.gather_rows(mesh, tok["codes"], 1), pmesh.gather_rows(mesh, tok["codes_lengths"])
        y = pmesh.gather_rows(mesh, progs["detokenize"](given[:, rows], clen[rows], width)["y"])
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3
    return codes.cpu().numpy(), y.to(torch.float32).cpu().numpy(), ms


def tp_capture_checks(torch, shard, mesh, wav, lens, work: Path, eager: dict, keep, dev) -> dict:
    """Each run of ``TP_CAPTURE_RUNS`` through ``tp_programs`` on this rank
    (NCCL): a first call captures, a second replays, counted and timed,
    against this rank's eager run (``eager``: label -> (codes, waveform,
    ms)): codes and waveforms bit for bit or not, their difference,
    ``trace_counts``, the launches the replays add."""
    from simwhisper_codec_tpu_torch.ops import _cuda

    out = {}
    for label in TP_CAPTURE_RUNS:
        codes_in = np.load(work / f"ref_{label}.npz")["codes"]
        progs = tp_programs(shard, label)
        tp_program_round_trip(torch, progs, wav, lens, label, mesh, codes_in, dev)  # captures both
        _cuda.reset_launch_counts()
        codes, y, ms = tp_program_round_trip(torch, progs, wav, lens, label, mesh, codes_in, dev)
        e_codes, e_y, e_ms = eager[label]
        out[label] = {"trace_counts": {d: p.count for d, p in progs.items()},
                      "sources": {d: p.source for d, p in progs.items()}, "launches": dict(_cuda.launch_counts),
                      "codes_bit_for_bit": bool(np.array_equal(codes, e_codes)),
                      "code_agreement": float(np.mean(codes == e_codes)),
                      "wave_bit_for_bit": bool(np.array_equal(y, e_y)),
                      "wave_max_abs_diff": float(np.abs(np.where(keep, y - e_y, 0.0)).max()),
                      "wave_max_abs": float(np.abs(np.where(keep, e_y, 0.0)).max()), "ms": ms, "eager_ms": e_ms}
        del progs
        torch.cuda.empty_cache()
    return out


def tp_capture_failures(label: str, run: dict, swap: dict, cfg, model_axis: int, where: str) -> list:
    """Where one captured TP run is off its rank's eager run: not one program
    a direction, not replayed, other launches than eager TP's, or codes and
    waveform neither bit for bit nor within this phase's bounds."""
    failures = []
    if run["trace_counts"] != {"tokenize": 1, "detokenize": 1} or set(run["sources"].values()) != {"replayed"}:
        failures.append(f"TP {where} {label} captured: programs {run['trace_counts']}, {run['sources']}")
    want = expected_tp_launches(label, cfg, model_axis)
    if run["launches"] != want:
        failures.append(f"TP {where} {label} captured: launches {run['launches']} != {want}")
    if not (run["codes_bit_for_bit"] and run["wave_bit_for_bit"]):
        parity = TP_RUNS[label][0] == "parity"
        agree = TP_PARITY_AGREEMENT if parity else TP_FAST_AGREEMENT
        wave = TP_PARITY_WAVE_RTOL * run["wave_max_abs"] if parity else TP_SWAP_FACTOR * swap["wave"]
        if run["code_agreement"] < agree or run["wave_max_abs_diff"] > wave:
            failures.append(f"TP {where} {label} captured vs eager: codes {run['code_agreement']:.6f} (>= {agree}), "
                            f"waveform {run['wave_max_abs_diff']:.4g} (<= {wave:.4g})")
    return failures


def expected_tp_launches(label: str, cfg, model_axis: int) -> dict:
    """Each rank's launches in one TP round trip (one tokenize, one detokenize of the batch)."""
    enc, dec, voc = cfg.acoustic_encoder, cfg.acoustic_decoder, cfg.vocos
    t_shape = f"{enc.d_model}x{enc.encoder_ffn_dim // model_axis}"
    v_shape = f"{voc.dim}x{voc.intermediate_dim // model_axis}"
    layers = enc.encoder_layers + dec.decoder_layers
    mode, attn_impl, vocos_impl = TP_RUNS[label]
    want = {}
    if mode == "parity":
        if attn_impl:
            want[f"{'pflash' if attn_impl == 'pflash' else 'flash'}_attention_f32"] = layers
        return want
    if attn_impl in (None, "flash"):
        want["flash_attention" if attn_impl == "flash" else "pflash_attention"] = layers
    if mode == "fast-int8":
        want[f"ln_ffn_bf16_partial:{t_shape}"] = enc.encoder_layers
        want[f"ln_ffn_int8_partial:{t_shape}"] = dec.decoder_layers
        want[f"ln_ffn_int8_partial:{v_shape}"] = voc.num_layers
    else:
        want[f"ln_ffn_bf16_partial:{t_shape}"] = layers
        want[f"{'convnext_dw_partial' if vocos_impl == 'fused-dw' else 'ln_ffn_bf16_partial'}:{v_shape}"] = voc.num_layers
    return want


def tp_layer_checks(torch, full, shard, device) -> dict:
    """Decoder layer 0 and Vocos block 0 in each program of
    ``TP_LAYER_RUNS``, this rank's shard over its model group against the
    whole layer in this process, on one seeded bf16 input (8 x 1500 decoder
    frames at ``TP_LENGTHS``' lengths, 8 x 3000 Vocos frames): mean |d| of
    the update (output - input) over the valid rows, over its mean |update|."""
    from simwhisper_codec_tpu_torch.models.codec import f32_precision, mode_programs

    layers = {"decoder": (full.acoustic_decoder.layers[0].to(device), shard.acoustic_decoder.layers[0]),
              "vocos": (full.vocos.backbone.convnext[0].to(device), shard.vocos.backbone.convnext[0])}
    gen, t = torch.Generator().manual_seed(3), max(TP_LENGTHS) // 320
    dec_x = torch.randn(8, t, layers["decoder"][0].fc1.in_features, generator=gen).to(torch.bfloat16).to(device)
    voc_x = torch.randn(8, 2 * t, layers["vocos"][0].dwconv.in_channels, generator=gen).to(torch.bfloat16).to(device)
    lengths = torch.as_tensor(np.array(TP_LENGTHS) // 320, device=device)
    valid = (torch.arange(t, device=device)[None, :] < lengths[:, None])[..., None]
    out = {}
    for label in (r for r in TP_LAYER_RUNS if r in TP_RUNS):
        detok = mode_programs(*TP_RUNS[label])[1]
        calls = {"decoder": lambda layer: layer(dec_x, None, lengths, detok["attn_impl"], detok["ffn_impl"]),
                 "vocos": lambda layer: layer(voc_x, None, detok["vocos_impl"], None)}
        out[label] = {}
        for name, (whole, part) in layers.items():
            x = dec_x if name == "decoder" else voc_x
            keep = valid if name == "decoder" else torch.ones_like(x[..., :1], dtype=torch.bool)
            with torch.no_grad(), f32_precision("default"):
                want, got = (calls[name](layer).float() - x.float() for layer in (whole, part))
            d = torch.where(keep, got - want, 0.0).abs().sum() / keep.sum() / x.shape[-1]
            out[label][name] = float(d) / float(torch.where(keep, want, 0.0).abs().sum() / keep.sum() / x.shape[-1])
    return out


def tp_worker(torch, work: Path, model_axis: int, backend: str) -> None:
    """One rank of a TP group (``--check tp``): the full-width model sharded
    over ``model_axis``, every run of ``TP_RUNS`` (a warm-up, then the
    counted, timed round trip, which decodes one process's codes) against
    the one-process references in ``work``, ``tp_layer_checks``, then the
    dry run's production geometry; results into ``work/tp_rank<r>.json``."""
    from simwhisper_codec_tpu_torch.config import load_config
    from simwhisper_codec_tpu_torch.ops import _cuda
    from simwhisper_codec_tpu_torch.parallel import dist, dryrun
    from simwhisper_codec_tpu_torch.parallel import mesh as pmesh

    ctx = dist.init_from_env(torch.device("cuda"), backend)
    device = dist.local_device(ctx, torch.device("cuda"))
    mesh = pmesh.make_mesh(model_axis=model_axis)
    cfg = load_config(TP_CONFIG)
    full = tp_model(torch, cfg)
    shard = pmesh.shard_model(full, mesh).to(device)
    batch = np.load(work / "batch.npz")
    wav, lens = batch["wav"], batch["lens"]
    out = {"rank": ctx.rank, "mesh": {"data": mesh.data_size, "model": mesh.model_size}, "backend": backend,
           "device": str(device), "runs": {}}
    frames, keep = tp_masks(lens, wav.shape[1])
    eager = {}
    for label in TP_RUNS:
        ref = np.load(work / f"ref_{label}.npz")
        held = np.load(work / f"ref_{TP_REFERENCE.get(label, label)}.npz")
        if backend == "nccl":  # a card a rank: the timed run comes warm
            tp_round_trip(torch, shard, wav, lens, label, mesh, ref["codes"])
        _cuda.reset_launch_counts()
        codes, y, fsq_in, ms = tp_round_trip(torch, shard, wav, lens, label, mesh, ref["codes"])
        launches = dict(_cuda.launch_counts)
        if label in TP_CAPTURE_RUNS:
            eager[label] = (codes, y, ms)
        fsq_diff = float(np.abs(np.where(frames[..., None], fsq_in - ref["fsq_in"], 0.0)).max())
        to_boundary = np.abs(ref["fsq_in"] - np.floor(ref["fsq_in"]) - 0.5)  # to the nearest rounding boundary
        out["runs"][label] = {
            "ms": ms, "launches": launches, "code_agreement": float(np.mean(codes == held["codes"])),
            "codes_differing": int(np.sum(codes != held["codes"])), "codes_shape_ok": codes.shape == held["codes"].shape,
            "finite": bool(np.isfinite(y).all()), "fsq_input_max_abs_diff": fsq_diff,
            "fsq_inputs_within_that_of_a_boundary": int(np.sum(frames[..., None] & (to_boundary <= fsq_diff))),
            "wave_max_abs_diff": float(np.abs(np.where(keep, y - ref["y"], 0.0)).max()),
            "wave_max_abs": float(np.abs(np.where(keep, ref["y"], 0.0)).max()),
            "distinct_codes": int(len(np.unique(codes)))}
    if backend == "nccl":  # one card a rank: the programs captured, as AudioCodec captures them
        out["captured"] = tp_capture_checks(torch, shard, mesh, wav, lens, work, eager, keep, device)
    del eager
    out["layers"] = tp_layer_checks(torch, full, shard, device)
    del shard, full
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(True)  # the training path (CUBLAS_WORKSPACE_CONFIG from det_env)
    res = dryrun.run(mesh, device, ("production-geometry",), log=log if ctx.rank == 0 else (lambda msg: None))
    out["dryrun"] = res
    (work / f"tp_rank{ctx.rank}.json").write_text(json.dumps(out))
    torch.distributed.destroy_process_group()


def tp_references(torch, cfg, work: Path) -> dict:
    """The one-process run of every ``TP_RUNS`` round trip on this card (a
    warm-up, then the timed one), and fast's codes decoded by fast-dw's
    program (the kernel-swap scale), saved into ``work`` for the ranks;
    returns ms."""
    work.mkdir(parents=True, exist_ok=True)
    wav, lens = tp_batch(cfg)
    np.savez(work / "batch.npz", wav=wav, lens=lens)
    model = tp_model(torch, cfg).to("cuda")
    ms = {}
    for label in TP_RUNS:
        tp_round_trip(torch, model, wav, lens, label)
        codes, y, fsq_in, ms[label] = tp_round_trip(torch, model, wav, lens, label)
        np.savez(work / f"ref_{label}.npz", codes=codes, y=y, fsq_in=fsq_in)
    y_swap = tp_round_trip(torch, model, wav, lens, "fast-dw", codes_in=np.load(work / "ref_fast.npz")["codes"])[1]
    np.save(work / "swap_y.npy", y_swap)
    del model
    torch.cuda.empty_cache()
    return ms


def tp_swap_scale(work: Path) -> dict:
    """The one-process kernel swap's max |d| (fast-dw against fast): FSQ
    input on the same audio, waveform from fast's codes."""
    batch, fast, dw = (np.load(work / f) for f in ("batch.npz", "ref_fast.npz", "ref_fast-dw.npz"))
    frames, keep = tp_masks(batch["lens"], batch["wav"].shape[1])
    return {"fsq": float(np.abs(np.where(frames[..., None], dw["fsq_in"] - fast["fsq_in"], 0.0)).max()),
            "wave": float(np.abs(np.where(keep, np.load(work / "swap_y.npy") - fast["y"], 0.0)).max()),
            "codes": share_equal([dw["codes"]], [fast["codes"]])}


def tp_run_failures(label: str, run: dict, swap: dict, where: str) -> list:
    """Where one TP round trip's codes, FSQ input or waveform are outside
    this phase's bounds of one process's (an empty list if nowhere)."""
    if not (run["finite"] and run["codes_shape_ok"]):
        return [f"TP {where} {label}: waveform finite {run['finite']}, codes' shape as one process's "
                f"{run['codes_shape_ok']}"]
    if TP_RUNS[label][0] == "parity":
        bounds = {"code_agreement": TP_PARITY_AGREEMENT, "fsq_input_max_abs_diff": TP_FSQ_TOL,
                  "wave_max_abs_diff": TP_PARITY_WAVE_RTOL * run["wave_max_abs"]}
    else:
        bounds = {"code_agreement": TP_FAST_AGREEMENT, "fsq_input_max_abs_diff": TP_SWAP_FACTOR * swap["fsq"],
                  "wave_max_abs_diff": TP_SWAP_FACTOR * swap["wave"]}
    failures = [f"TP {where} {label}: {key} {run[key]:.4g} > its bound {bounds[key]:.4g}"
                for key in ("fsq_input_max_abs_diff", "wave_max_abs_diff") if run[key] > bounds[key]]
    if run["code_agreement"] < bounds["code_agreement"]:
        failures.append(f"TP {where} {label}: code agreement {run['code_agreement']:.6f} with one process < "
                        f"{bounds['code_agreement']}")
    return failures


def tp_group(torch, cfg, work: Path, model_axis: int, n_ranks: int, backend: str, one_process_ms: dict) -> dict:
    """``tp_worker`` over ``n_ranks`` processes: on this one card over gloo
    (two processes share it), or one card a rank over NCCL (torchrun);
    checks every rank's results; returns rank 0's."""
    for old in work.glob("tp_rank*.json"):
        old.unlink()
    common = [__file__, "--check", "tp", "--work_dir", str(work), "--tp_model_axis", str(model_axis),
              "--tp_backend", backend]
    t0 = time.perf_counter()
    if backend == "gloo":  # every rank on card 0
        port = free_port()
        procs = [start(common, work / f"tp{r}.log", det_env(RANK=str(r), LOCAL_RANK="0", WORLD_SIZE=str(n_ranks),
                                                             MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)))
                 for r in range(n_ranks)]
        for r, proc in enumerate(procs):
            finish(f"TP rank {r}", proc, work / f"tp{r}.log", 900)
    else:
        proc = start(["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(n_ranks), *common],
                     work / "tp.log")
        finish("TP ranks", proc, work / "tp.log", 900)
    wall = time.perf_counter() - t0
    results = [json.loads((work / f"tp_rank{r}.json").read_text()) for r in range(n_ranks)]
    geometry = f"{n_ranks // model_axis} data x {model_axis} model"
    swap = tp_swap_scale(work)
    log(f"[tp] one process, for scale: fast-dw against fast (a bf16 kernel swap): codes {swap['codes']:.6f} equal, "
        f"FSQ input max |d| {swap['fsq']:.4g}, waveforms from fast's codes max |d| {swap['wave']:.4g}; the fast "
        f"modes' bounds are {TP_SWAP_FACTOR} times these")
    for label, run in results[0]["runs"].items():
        held = TP_REFERENCE.get(label, label)
        log(f"[tp] {geometry} ({backend}) {label}: codes {run['code_agreement']:.6f} equal to one process's "
            f"{held} ({run['codes_differing']} differ, {run['distinct_codes']} distinct), FSQ input max |d| "
            f"{run['fsq_input_max_abs_diff']:.4g} ({run['fsq_inputs_within_that_of_a_boundary']} of one process's "
            f"within that of a rounding boundary), waveforms from one process's codes max |d| "
            f"{run['wave_max_abs_diff']:.4g} (max |y| {run['wave_max_abs']:.4g}), round trip {run['ms']:.1f} ms "
            f"(one process {one_process_ms[label]:.1f} ms), launches a rank {json.dumps(run['launches'])}")
    for label, run in results[0].get("captured", {}).items():
        log(f"[tp] {gpu_line()}: {geometry} ({backend}) {label} as CUDA graphs against eager on rank 0: codes bit "
            f"for bit {run['codes_bit_for_bit']} ({run['code_agreement']:.6f} equal), waveforms bit for bit "
            f"{run['wave_bit_for_bit']} (max |d| {run['wave_max_abs_diff']:.4g}), programs {run['trace_counts']}, "
            f"round trip {run['ms']:.1f} ms captured, {run['eager_ms']:.1f} ms eager; launches a rank "
            f"{json.dumps(run['launches'])}")
    for label, rel in results[0]["layers"].items():
        log(f"[tp] {geometry} ({backend}) {label}, one layer on one input, sharded against whole: mean |d| of the "
            f"update over its mean |update|: decoder layer {rel['decoder']:.3g}, Vocos block {rel['vocos']:.3g} "
            f"(<= {TP_LAYER_MEAN_RTOL})")
    dr = results[0]["dryrun"][0]
    log(f"[tp] {geometry} ({backend}) dry run, production geometry: loss {dr['loss']:.6f} vs {dr['ref_loss']:.6f} "
        f"(rtol 1e-4), gradients from one cotangent {dr['grad_rel_err']:.3g} at {dr['worst']} (< 2e-3); whole "
        f"step {dr['step_grad_rel_err']:.3g} (audio {dr['audio_rel_diff']:.3g}, audio cotangent "
        f"{dr['cotangent_rel_diff']:.3g}), against a second f32 program of the unsharded step ({dr['witness']}): "
        f"whole step {dr['witness_step_grad_rel_err']:.3g} (audio {dr['witness_audio_rel_diff']:.3g}, audio "
        f"cotangent {dr['witness_cotangent_rel_diff']:.3g}); replicated grads equal across model ranks, "
        f"AdamW step {dr['step_ms']:.1f} ms (one process, whole batch of {dr['batch']}: "
        f"{dr['one_process_step_ms']:.1f} ms); {n_ranks} ranks in {wall:.1f} s")
    failures = []  # every check, so that a failure names all it broke
    for res in results:
        where = f"{geometry} rank {res['rank']}"
        for label, run in res["runs"].items():
            want = expected_tp_launches(label, cfg, model_axis)
            if run["launches"] != want:
                failures.append(f"TP {where} {label}: launches {run['launches']} != {want}")
            failures += tp_run_failures(label, run, swap, where)
        for label, run in res.get("captured", {}).items():
            failures += tp_capture_failures(label, run, swap, cfg, model_axis, where)
        if backend == "nccl" and set(res.get("captured", {})) != set(TP_CAPTURE_RUNS):
            failures.append(f"TP {where}: captured runs {sorted(res.get('captured', {}))}")
        failures += [f"TP {where} {label}: the {name} layer's update differs from the whole layer's by {rel:.3g} of "
                     f"its mean |update| (> {TP_LAYER_MEAN_RTOL})"
                     for label, rels in res["layers"].items() for name, rel in rels.items() if rel > TP_LAYER_MEAN_RTOL]
        dr = res["dryrun"][0]
        if not (dr["grad_rel_err"] < 2e-3 and dr["replicated_max_diff"] == 0.0):
            failures.append(f"TP {where} dry run: {dr}")
    assert not failures, "; ".join(failures)
    return results[0]


def _slice_block(block, mesh):
    """A copy of a ConvNeXt block holding one model rank's slice of I."""
    from simwhisper_codec_tpu_torch.models.vocos import ConvNeXtBlock
    from simwhisper_codec_tpu_torch.parallel.mesh import param_sharding_rules, shard

    c, inter = block.pwconv2.weight.shape
    part = ConvNeXtBlock(c, inter // mesh.model_size, 1.0).to(block.gamma.device)
    part.load_state_dict({k: shard(v, param_sharding_rules(k), mesh) for k, v in block.state_dict().items()})
    return part


def tp_kernel_rows(torch) -> list:
    """B1 / B5 on a rank's local heads (6 of 12 at model = 2, 3 at model =
    4; bf16 rows, f32 compared only) and the partial modes of B2, B3 and B4
    on every rank's slice of I, held against their plain versions with
    tolerances sized to the partial's own scale (``PARTIAL_MAX_RTOL``,
    ``PARTIAL_MEAN_RTOL``), rank 0's timed; a row a kernel at its model = 2
    shape, the model = 4 shape's numbers under ``model4``.  Then every
    rank's partial summed against the unsharded plain function's f32 output
    before the residual (the partial plain version on all of I, b2 once),
    B3 with the row max over all of I, as the all-reduce gives it."""
    from simwhisper_codec_tpu_torch.models.codec import f32_precision
    from simwhisper_codec_tpu_torch.ops import flash_attention as fa
    from simwhisper_codec_tpu_torch.ops import fused_convnext as fc
    from simwhisper_codec_tpu_torch.ops.quant import quantize_weight
    from simwhisper_codec_tpu_torch.parallel.mesh import Mesh, shard

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device="cpu").manual_seed(2)

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen) * scale).to(dtype).to(dev)

    def nest(rows4, row):
        keep = ("name", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        row["model4"] = {k: rows4[k] for k in keep if k in rows4}
        return row

    rows = []
    b, t, hd = 8, 1500, 64
    lengths = torch.tensor([1500, 1500, 1211, 900, 640, 333, 17, 0], dtype=torch.int32, device=dev)
    attn = {}
    for heads in (6, 3):
        d = heads * hd
        qkv = randn(b, t, 3 * d)
        qkv[..., :d] *= hd ** -0.5
        flops = sum(4.0 * heads * t * n * hd if n > 0 else 2.0 * heads * t * t * hd for n in lengths.tolist())
        nbytes = qkv.numel() * 2 + b * t * d * 2 + lengths.numel() * 4
        q, k, v = head_views(qkv, heads)
        key_mask = (torch.arange(t, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        sdpa = lambda q=q, k=k, v=v: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=key_mask,
                                                                                      scale=1.0)
        attn[heads] = [
            check_kernel(torch, f"pflash_attention ({heads} heads)", fa.fused_qkv_attention,
                         fa.fused_qkv_attention_plain, (qkv, lengths, heads), 1e-2, 1.6e-2, flops, H100_BF16_FLOPS,
                         nbytes, "simwhisper_codec_tpu/ops/flash_attention.py:162",
                         "simwhisper_codec_tpu_torch/csrc/pflash.cu", library=sdpa),
            check_kernel(torch, f"flash_attention ({heads} heads)", fa.flash_attention, fa.flash_attention_plain,
                         (q, k, v, lengths), 1e-2, 1.6e-2, flops, H100_BF16_FLOPS, nbytes,
                         "simwhisper_codec_tpu/ops/flash_attention.py:62", "simwhisper_codec_tpu_torch/csrc/flash.cu",
                         library=sdpa)]
        q32 = qkv.to(torch.float32)
        with f32_precision("highest"):
            compare(torch, f"pflash_attention_f32 ({heads} heads)", fa.fused_qkv_attention(q32, lengths, heads),
                    fa.fused_qkv_attention_plain(q32, lengths, heads), 1e-5, 1e-5)
            views = (*head_views(q32, heads), lengths)
            compare(torch, f"flash_attention_f32 ({heads} heads)", fa.flash_attention(*views),
                    fa.flash_attention_plain(*views), 1e-5, 1e-5)
    rows += [nest(r4, r2) for r2, r4 in zip(attn[6], attn[3])]

    for (m, c, inter, eps, vocos) in ((8 * 1500, 768, 3072, 1e-5, False), (8 * 3000, 512, 4096, 1e-6, True)):
        x = randn(m, c)
        ln_w, ln_b = randn(c, scale=0.1) + 1.0, randn(c, scale=0.1)
        w1 = randn(inter, c, scale=c ** -0.5, dtype=torch.float32)
        w2 = randn(c, inter, scale=inter ** -0.5, dtype=torch.float32)
        b1, b2 = randn(inter, scale=0.02), randn(c, scale=0.02)
        gamma = randn(c, scale=0.01) + 1.0 / 24 if vocos else None
        w1b, w2b = w1.to(bf), w2.to(bf)
        (w1q, s1), (w2q, s2) = quantize_weight(w1), quantize_weight(w2)  # whole, then sliced
        h = fc.fused_ln_ffn_int8_up_plain(x, ln_w, ln_b, w1q, s1, b1, eps)
        hmax_bits = h.abs().amax(-1).view(torch.int32)
        del h
        hook = lambda local: local.copy_(hmax_bits)  # the all-reduce (MAX) over the group, as its result
        int8_kernel = lambda *a: fc.ln_ffn_int8_partial(*a, reduce_max=hook)
        int8_plain = lambda *a: fc.fused_ln_ffn_int8_partial_plain(*a, reduce_max=hook)
        kinds = [("ln_ffn_bf16_partial", fc.ln_ffn_partial, fc.fused_ln_ffn_partial_plain,
                  lambda g: (x, ln_w, ln_b, shard(w1b, 0, g), shard(b1, 0, g), shard(w2b, 1, g),
                             fc.rank_bias(b2, g.model_rank == 0), gamma, eps),
                  "simwhisper_codec_tpu/ops/fused_convnext.py:38", "simwhisper_codec_tpu_torch/csrc/ln_ffn.cu"),
                 ("ln_ffn_int8_partial", int8_kernel, int8_plain,
                  lambda g: (x, ln_w, ln_b, shard(w1q, 0, g), shard(s1, 0, g), shard(b1, 0, g), shard(w2q, 1, g), s2,
                             fc.rank_bias(b2, g.model_rank == 0), gamma, eps),
                  "simwhisper_codec_tpu/ops/fused_convnext.py:296", "simwhisper_codec_tpu_torch/csrc/ln_ffn_int8.cu")]
        if vocos:
            x4 = x.reshape(8, 3000, c)
            block = random_block(torch, randn, c, inter)
            kinds.append(("convnext_dw_partial", fc.convnext_dw_partial, fc.fused_convnext_block_dw_partial_plain,
                          lambda g: (x4, _slice_block(block, g), 2875, 1e-6,
                                     fc.rank_bias(block.pwconv2.bias, g.model_rank == 0)),
                          "simwhisper_codec_tpu/ops/fused_convnext.py:195",
                          "simwhisper_codec_tpu_torch/csrc/convnext_dw.cu"))
        found = {}
        for k in (2, 4):
            loc = inter // k
            meshes = [Mesh(1, k, 0, r) for r in range(k)]
            ops = 4.0 * m * c * loc
            act = m * c * 2 + m * c * 4  # x read, the f32 partial written
            cost = {"ln_ffn_bf16_partial": (ops, H100_BF16_FLOPS, act + 2 * c * loc * 2 + (2 * c + loc) * 2),
                    "ln_ffn_int8_partial": (ops, H100_INT8_OPS, act + 2 * c * loc + (loc + c) * 4 + (2 * c + loc) * 2),
                    "convnext_dw_partial": (ops + 14.0 * m * c, H100_BF16_FLOPS,
                                            act + 2 * c * loc * 2 + (7 * c + 5 * c + loc) * 2)}
            found[k] = []
            for name, kernel, plain, rank_args, replaces, source in kinds:
                name = f"{name}:{c}x{loc}"
                args = [rank_args(g) for g in meshes]
                found[k].append(check_kernel(torch, name, kernel, plain, args[0], *partial_tol(torch, plain(*args[0])),
                                             *cost[name.split(":")[0]], replaces, source, iters=10,
                                             mean_rtol=PARTIAL_MEAN_RTOL))
                for r, a in enumerate(args[1:], 1):
                    compare(torch, f"{name} rank {r}", kernel(*a), plain(*a), *partial_tol(torch, plain(*a)),
                            mean_rtol=PARTIAL_MEAN_RTOL)
                # every rank's partial summed against the unsharded function before the residual
                whole = plain(*rank_args(Mesh(1, 1, 0, 0)))
                compare(torch, f"{name} x{k} summed", sum(kernel(*a) for a in args), whole,
                        *partial_tol(torch, whole), mean_rtol=PARTIAL_MEAN_RTOL)
        rows += [nest(r4, r2) for r2, r4 in zip(found[2], found[4])]
    return rows


def tp_phase(torch, cfg, work: Path) -> tuple:
    """Phase 8: ``tp_kernel_rows``, the one-process references, then a
    model group of 2 as two processes sharing this card over gloo (every
    kernel on the card, the transport the host's); returns the kernel rows
    and rank 0's launches by run."""
    t_phase = time.perf_counter()
    with torch.no_grad():
        rows = tp_kernel_rows(torch)
    torch.cuda.empty_cache()
    one_process_ms = tp_references(torch, cfg, work)
    first = tp_group(torch, cfg, work, 2, 2, "gloo", one_process_ms)
    log(f"[tp] phase: {time.perf_counter() - t_phase:.1f} s")
    return rows, {label: run["launches"] for label, run in first["runs"].items()}


def tp_gpus_phase(torch, n_gpus: int, work: Path) -> None:
    """``--tp_gpus N``: the one-process references on card 0, then the TP
    ranks one card each over NCCL at (1 data x N model) and, for N = 4,
    (1 x 2) on two of the cards and (2 x 2); each rank's programs eager and
    captured (``TP_CAPTURE_RUNS``)."""
    from simwhisper_codec_tpu_torch.config import load_config

    cfg = load_config(TP_CONFIG)
    log(f"[tp] {gpu_line()} (x{torch.cuda.device_count()})")
    one_process_ms = tp_references(torch, cfg, work)
    for model_axis, n_ranks in (((2, 2), (4, 4), (2, 4)) if n_gpus == 4 else ((n_gpus, n_gpus),)):
        tp_group(torch, cfg, work, model_axis, n_ranks, "nccl", one_process_ms)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dp_gpus", type=int, default=0,
                    help="run only the data-parallel checks (dp_phase) over this many GPUs")
    ap.add_argument("--discriminator_timing", action="store_true",
                    help="run only discriminator_timing, deterministic kernels against cuDNN autotuning")
    ap.add_argument("--tp_gpus", type=int, default=0,
                    help="run only the tensor-parallel serving and dry-run checks of phase 8 over this many GPUs "
                         "(NCCL; at 4: 1 data x 4 model, then 2 x 2)")
    ap.add_argument("--check", choices=("card-vs-cpu", "dp", "tp", "train-graph"), default=None,
                    help="one check of phase 5 or 8, as the full run starts it in a child process")
    ap.add_argument("--work_dir", default=None, help="scratch directory of --dp_gpus / --tp_gpus / --check dp|tp")
    ap.add_argument("--tp_model_axis", type=int, default=2, help="--check tp: ranks of the model axis")
    ap.add_argument("--tp_backend", choices=("gloo", "nccl"), default="gloo",
                    help="--check tp: the process-group backend (gloo: ranks may share a card)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.check == "card-vs-cpu":
        card_vs_cpu_check(torch)
        return 0
    if args.check == "dp":
        dp_worker(torch, Path(args.work_dir))
        return 0
    if args.check == "train-graph":
        train_graph_check(torch)
        return 0
    if args.check == "tp":
        tp_worker(torch, Path(args.work_dir), args.tp_model_axis, args.tp_backend)
        return 0
    if args.discriminator_timing:
        discriminator_timing(torch, ("deterministic", "autotuned", "autotuned", "deterministic"))
        return 0
    if args.dp_gpus:
        with tempfile.TemporaryDirectory() as tmp:
            dp_phase(torch, args.dp_gpus, Path(args.work_dir or tmp))
        return 0
    if args.tp_gpus:
        with tempfile.TemporaryDirectory() as tmp:
            tp_gpus_phase(torch, args.tp_gpus, Path(args.work_dir or tmp))
        return 0
    from simwhisper_codec_tpu_torch.config import load_config
    from simwhisper_codec_tpu_torch.models.codec import init_params
    from simwhisper_codec_tpu_torch.ops import _cuda

    log(f"[gpu] {gpu_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[build] {len(_cuda.SOURCES)} kernels built in {_cuda.build_kernels():.1f} s")
    log_build_reports(_cuda.build_dir(), _cuda.SOURCES)
    with torch.no_grad():
        rows = kernel_phase(torch)
        int8_ffn_check(torch)
    torch.cuda.empty_cache()
    cfg = load_config("config/SimWhisperCodec.yaml")
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator().manual_seed(0))
    log(f"[codec] full-width random weights: {sum(p.numel() for p in model.parameters())} parameters, "
        f"init {time.perf_counter() - t0:.1f} s")
    launches, serving_codec, stage_ms = codec_phase(torch, cfg, model)
    corpus_phase(torch, cfg, serving_codec)
    with tempfile.TemporaryDirectory() as towers:
        eval_phase(torch, cfg, serving_codec, Path(towers))
        serve_and_cli_phase(torch, cfg, model)
        tools_phase(torch, cfg, serving_codec, stage_ms, Path(towers))
    launches.update(bench_phase(torch, cfg, model, serving_codec))
    del model, serving_codec
    torch.cuda.empty_cache()
    training_phase(torch)
    launches.update(variants_phase(torch))
    with tempfile.TemporaryDirectory() as work:
        tp_rows, tp_launches = tp_phase(torch, cfg, Path(work))
    for row in rows:  # launches on the serving default's path, else on the first run that launched it
        row["launches"] = next((launches[r][row["name"]] for r in ("fast-int8", "fast", "fast-flash-dw",
                                                                  "parity-pflash", "parity-flash")
                                if launches[r].get(row["name"])), 0)
        row["launches_by_run"] = {r: launches[r].get(row["name"], 0) for r in launches}
    for row in tp_rows:  # launches on a rank of phase 8's model group of 2 (the first TP run that launched it)
        key = row["name"].split(" (")[0]
        row["launches"] = next((n[key] for n in tp_launches.values() if n.get(key)), 0)
        row["launches_by_run"] = {f"tp-{r}": n.get(key, 0) for r, n in tp_launches.items()}
        assert row["launches"] > 0, f"{row['name']} was not launched on the TP path"
    rows += tp_rows
    print(gpu_line())  # name and power limit, as nvidia-smi prints them
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
