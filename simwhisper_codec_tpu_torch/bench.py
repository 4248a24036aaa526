"""Benchmark: the codec's full-size encode + decode round trip on one GPU.

Twin of the JAX package's top-level ``bench.py``.  Prints, as its last line,
ONE JSON object with the same 16 keys:
  {"metric": "codec_round_trip_throughput", "value": N, "unit": "x_realtime_per_chip",
   "vs_baseline": N, "headline_mode": ..., ...}

The benchmarked programs are the serving programs: ``CodecConfig()`` with
random weights (``init_params``, seed 0), each direction built by
``models/codec.py::serving_program``, the builder ``AudioCodec`` uses
(``fast`` for the bf16 round trip, ``fast-int8``'s detokenize for the mixed
section, ``fast-int8-full``'s tokenize for the full one): a ``utils/aot.py``
``CapturedProgram`` (one CUDA graph per signature, all on one graph pool), at
``default`` precision (TF32 on) as ``AudioCodec`` runs the fast modes.  The
int8 weights are added to the same model by ``quantize_for_mode``, as
``AudioCodec`` adds them.  Input: a batch of ``BENCH_BATCH`` (16) x 30 s of
N(0, 0.1^2) noise from ``np.random.default_rng(0)``, full lengths, the chunk
width a device int32.

The headline ``value`` is the serving default, ``fast-int8`` (mixed): bf16
tokenize + int8 detokenize, whose codes equal the bf16 codes by
construction.  ``bf16_x_realtime`` is the pure bf16 round trip;
``int8_x_realtime`` int8 on both sides, with ``int8_code_agreement_vs_bf16``
the share of its codes equal to the bf16 codes.  ``headline_mode`` says
which round trip ``value`` is: it falls back to ``"fast(bf16)"`` only when
``BENCH_INT8_BUDGET`` (s, default 1500, checked between steps, never
during one) or ``BENCH_SKIP_INT8`` left the int8 section out.  A failure
inside the int8 section ends the run with a nonzero exit and no JSON line.

Throughput is *pipelined*: ``BENCH_ITERS`` (10) round trips chained through
a device-side accumulator (``acc + y.abs().sum()``, in f32: every
program's whole output feeds it) and one host read at the end.  A replay copies the inputs
into the graph's buffers, launches the graph and clones the outputs, none
of which waits for the card, so the host runs ahead of the device.
``latency_x_realtime`` reads the accumulator after every round trip.

``vs_baseline`` is ``value / 10``: the JAX bench's fixed target of 10x real
time per chip, not a measurement.  MFU: the ``utils/flops.py`` ledger's
FLOPs per audio second times ``bf16_x_realtime`` over the card's dense bf16
peak (``peak_tflops``: 989.4 TFLOP/s for an "H100 80GB HBM3", 0 on the CPU
or an unknown card; ``BENCH_PEAK_TFLOPS`` overrides it).

``SIMWHISPER_FUSED_VOCOS`` picks the Vocos of the bf16 ``detokenize``, as
it does in the JAX bench: unset or ``1``, the fused pointwise chain
(``vocos_impl="fused"``, B2); ``dw``, the whole ConvNeXt block
(``vocos_impl="fused-dw"``, B4); any other value is an error.  The int8
sections keep the int8 Vocos whatever it says, as the JAX bench's do.

The kernel libraries are built into and loaded from ``BENCH_AOT_DIR``
(default ``.aot_cache/bench`` at the repository root), so a later run skips
``nvcc``; the graphs are captured again in every process.

Run:  python -m simwhisper_codec_tpu_torch.bench               # on the card
      python -m simwhisper_codec_tpu_torch.bench --device cpu  # the plain kernel versions
Without CUDA and without ``--device cpu`` it exits 3 with a one-line
message; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from simwhisper_codec_tpu_torch.config import CodecConfig
from simwhisper_codec_tpu_torch.models.codec import f32_precision, init_params, quantize_for_mode, serving_program
from simwhisper_codec_tpu_torch.ops import _cuda
from simwhisper_codec_tpu_torch.utils import aot
from simwhisper_codec_tpu_torch.utils.flops import codec_flops, peak_tflops

REPO_ROOT = Path(__file__).resolve().parents[1]
DEFAULT_AOT_DIR = REPO_ROOT / ".aot_cache" / "bench"
TARGET_X_REALTIME = 10.0  # the JAX bench's fixed per-chip target (vs_baseline = value / 10)
KERNEL_SOURCES = ("pflash", "ln_ffn", "ln_ffn_int8")  # the csrc/ libraries the bench's programs launch
# SIMWHISPER_FUSED_VOCOS -> the bf16 detokenize's vocos_impl (unset: "fused")
FUSED_VOCOS = {"1": "fused", "dw": "fused-dw"}
# the serving mode each program's keyword arguments come from
PROGRAM_MODES = {"tok": ("fast", "tokenize"), "detok": ("fast", "detokenize"),
                 "detok8": ("fast-int8", "detokenize"), "tok8": ("fast-int8-full", "tokenize")}
# section (as ``headline_mode`` names it) -> its tokenize and detokenize programs
SECTIONS = {"fast(bf16)": ("tok", "detok"), "fast-int8(mixed)": ("tok", "detok8"),
            "fast-int8(full)": ("tok8", "detok8")}


def fused_vocos_impl(value: Optional[str] = None) -> str:
    """The bf16 ``detokenize``'s ``vocos_impl`` for a ``SIMWHISPER_FUSED_VOCOS``
    value (default: the variable's): ``fused`` when unset or ``1``,
    ``fused-dw`` for ``dw``; raises ``ValueError`` on any other value."""
    value = os.environ.get("SIMWHISPER_FUSED_VOCOS") if value is None else value
    if not value:
        return "fused"
    if value not in FUSED_VOCOS:
        raise ValueError(f"SIMWHISPER_FUSED_VOCOS must be unset, 1 or dw, got {value!r}")
    return FUSED_VOCOS[value]


def kernel_sources(vocos_impl: str = "fused") -> tuple:
    """The csrc/ libraries the bench's programs launch with this bf16 Vocos."""
    return KERNEL_SOURCES + (("convnext_dw",) if vocos_impl == "fused-dw" else ())


def programs(model, vocos_impl: str = "fused") -> Dict[str, aot.CapturedProgram]:
    """The bench's four programs on ``model``, on one graph pool: ``tok`` /
    ``detok`` (``fast``; ``detok``'s Vocos is ``vocos_impl``), ``detok8``
    (``fast-int8``'s detokenize) and ``tok8`` (``fast-int8-full``'s
    tokenize), each ``AudioCodec``'s own (``serving_program``).  The int8
    ones need ``quantize_for_mode(model, "fast-int8-full")``."""
    pool = aot.GraphPool()
    return {name: serving_program(model, mode, direction, pool, vocos_impl=vocos_impl if name == "detok" else None)
            for name, (mode, direction) in PROGRAM_MODES.items()}


def inputs(cfg: CodecConfig, batch: int, device) -> tuple:
    """(wav (batch, chunk) f32, lengths (batch,) int64, chunk width 0-d int32),
    on ``device``: the JAX bench's noise, full lengths, ``code_frames``."""
    rng = np.random.default_rng(0)
    wav = torch.from_numpy((rng.standard_normal((batch, cfg.chunk_samples)) * 0.1).astype(np.float32))
    lengths = torch.full((batch,), cfg.chunk_samples, dtype=torch.int64)
    frame_valid = torch.tensor(cfg.code_frames, dtype=torch.int32)
    return wav.to(device), lengths.to(device), frame_valid.to(device)


def accum(y: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """The device-side accumulator: it depends on the whole output, so no
    program can be skipped; summed in f32 (a bf16 sum of a batch's |y|
    keeps 8 bits, too coarse to tell one round trip's output from another's)."""
    return acc + y.abs().sum(dtype=torch.float32)


def round_trip(tok, detok, batch_inputs: tuple, acc: torch.Tensor) -> tuple:
    """One tokenize + detokenize of the inputs -> (accumulator, codes)."""
    wav, lengths, frame_valid = batch_inputs
    t = tok(wav, lengths)
    d = detok(t["codes"], t["codes_lengths"], frame_valid)
    return accum(d["y"], acc), t["codes"]


def round_trips(progs: Dict[str, aot.CapturedProgram], batch_inputs: tuple) -> Dict[str, Callable]:
    """Section -> ``acc -> (acc, codes)``: its round trip on the inputs."""
    return {section: functools.partial(round_trip, progs[tok], progs[detok], batch_inputs)
            for section, (tok, detok) in SECTIONS.items()}


def chain(rt: Callable, acc: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` round trips chained through the accumulator; no host read."""
    for _ in range(iters):
        acc, _ = rt(acc)
    return acc


def _read(acc: torch.Tensor, where: str) -> float:
    value = float(acc)
    if not math.isfinite(value):
        raise FloatingPointError(f"{where}: the accumulator is {value}")
    return value


def pipelined_s(rt: Callable, iters: int, zero: torch.Tensor, where: str) -> float:
    """Seconds of ``iters`` chained round trips and the one host read that ends them."""
    start = time.perf_counter()
    _read(chain(rt, zero, iters), where)
    return time.perf_counter() - start


def latency_s(rt: Callable, iters: int, zero: torch.Tensor, where: str) -> float:
    """Seconds of ``iters`` round trips, each read on the host."""
    start = time.perf_counter()
    for _ in range(iters):
        _read(rt(zero)[0], where)
    return time.perf_counter() - start


def run(cfg: CodecConfig, device="cuda", batch: int = 16, iters: int = 10, *, int8_budget_s: float = 1500.0,
        skip_int8: bool = False, peak_tflops_bf16: Optional[float] = None, vocos_impl: str = "fused") -> dict:
    """The bench at ``cfg`` on ``device``: the 16-key record of the JAX bench
    (weights from ``init_params`` at seed 0), the bf16 ``detokenize`` with
    ``vocos_impl``; prints a ``bench:`` line per section."""
    log = functools.partial(print, flush=True)
    device = torch.device(device)
    if device.type == "cuda":
        _cuda.build_kernels(kernel_sources(vocos_impl))
    model = init_params(cfg, torch.Generator().manual_seed(0)).to(device).eval()
    progs = programs(model, vocos_impl)
    batch_inputs = inputs(cfg, batch, device)
    rts = round_trips(progs, batch_inputs)
    zero = torch.zeros((), device=device)
    chunk_s = cfg.chunk_samples / cfg.input_sample_rate
    audio_seconds = iters * batch * chunk_s

    def section_rate(section: str) -> float:
        """Pipelined x real time of a section whose programs are captured; logs its launches a round trip."""
        _cuda.reset_launch_counts()
        elapsed = pipelined_s(rts[section], iters, zero, section)
        launches = {k: n // iters for k, n in sorted(_cuda.launch_counts.items())}
        log(f"bench: {section}: {audio_seconds / elapsed:.2f} x real time pipelined; launches a round trip "
            f"{json.dumps(launches)}")
        return audio_seconds / elapsed

    int8_x_realtime = int8_agreement = int8_mixed_x_realtime = None
    with torch.no_grad(), f32_precision("default"):
        _read(rts["fast(bf16)"](zero)[0], "warm-up")  # captures tok + detok
        elapsed_sync = latency_s(rts["fast(bf16)"], iters, zero, "latency")
        bf16_x_realtime = section_rate("fast(bf16)")
        latency_x_realtime = audio_seconds / elapsed_sync

        # int8 sections: mixed first (the headline), then full; the budget is
        # checked between steps only, a step in flight always completes
        int8_deadline = time.perf_counter() + int8_budget_s

        def budget_ok(step: str) -> bool:
            if int8_deadline - time.perf_counter() <= 0:
                log(f"bench: int8 budget exhausted before {step}; skipping the rest")
                return False
            return True

        if skip_int8:
            log("bench: BENCH_SKIP_INT8 set; the int8 sections are left out")
        else:
            quantize_for_mode(model, "fast-int8-full")  # fast-int8's weights and the encoder's
            if budget_ok("mixed-mode capture"):
                _read(rts["fast-int8(mixed)"](zero)[0], "int8 mixed warm-up")
                int8_mixed_x_realtime = round(section_rate("fast-int8(mixed)"), 2)
            if budget_ok("int8-full capture"):
                a8, codes8 = rts["fast-int8(full)"](zero)
                _read(a8, "int8 full warm-up")
                codes_bf = progs["tok"](*batch_inputs[:2])["codes"]
                int8_agreement = round(float((codes8 == codes_bf).float().mean()), 4)
                if budget_ok("int8-full timing"):
                    int8_x_realtime = round(section_rate("fast-int8(full)"), 2)

    if int8_mixed_x_realtime is not None:
        headline, headline_mode = int8_mixed_x_realtime, "fast-int8(mixed)"
    else:
        headline, headline_mode = bf16_x_realtime, "fast(bf16)"
    flops_per_audio_sec = codec_flops(cfg)["total"] / chunk_s
    achieved_tflops = flops_per_audio_sec * bf16_x_realtime / 1e12
    peak = peak_tflops_bf16 or peak_tflops(device)
    mfu = achieved_tflops / peak if peak else 0.0
    return {
        "metric": "codec_round_trip_throughput",
        "value": round(headline, 2),
        "unit": "x_realtime_per_chip",
        "vs_baseline": round(headline / TARGET_X_REALTIME, 3),
        "headline_mode": headline_mode,
        "bf16_x_realtime": round(bf16_x_realtime, 2),
        "latency_x_realtime": round(latency_x_realtime, 2),
        "flops_per_audio_sec": round(flops_per_audio_sec / 1e9, 2),
        "flops_unit": "GFLOP_per_audio_sec",
        "achieved_tflops": round(achieved_tflops, 2),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "peak_tflops_bf16": peak,
        "mfu": round(mfu, 4),
        "int8_x_realtime": int8_x_realtime,
        "int8_code_agreement_vs_bf16": int8_agreement,
        "int8_mixed_x_realtime": int8_mixed_x_realtime,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    args = ap.parse_args(argv)
    vocos_impl = fused_vocos_impl()  # a bad value fails before anything runs
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device (torch.cuda.is_available() is false); cannot produce numbers: "
              "pass --device cpu to run on the CPU", flush=True)
        raise SystemExit(3)
    if device.type == "cuda":
        _cuda.use_aot_dir(os.environ.get("BENCH_AOT_DIR", str(DEFAULT_AOT_DIR)) or None)
    record = run(CodecConfig(), device,
                 batch=int(os.environ.get("BENCH_BATCH", "16")),
                 iters=int(os.environ.get("BENCH_ITERS", "10")),
                 int8_budget_s=float(os.environ.get("BENCH_INT8_BUDGET", "1500")),
                 skip_int8=bool(os.environ.get("BENCH_SKIP_INT8")),
                 peak_tflops_bf16=float(os.environ.get("BENCH_PEAK_TFLOPS", 0)) or None, vocos_impl=vocos_impl)
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
