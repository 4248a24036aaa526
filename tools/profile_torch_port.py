#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's codec stages on one GPU.

Builds the full-width codec (config/SimWhisperCodec.yaml, random weights
from a fixed seed), warms it (which captures its two CUDA graphs,
``utils/aot.py``), then traces one tokenize and one detokenize of a batch
of 8 x 30 s with ``torch.profiler``, as graph replays and once more under
``utils.aot.eager()`` (op by op), for each requested configuration
(the serving modes; ``flash-dw``: fast mode with the B5 attention core and
the B4 whole-block Vocos kernel; ``fast-dw``: fast mode with B4, attention
as in ``fast``, so that its detokenize differs from fast's in the Vocos
alone; ``parity-pflash`` / ``parity-flash``: parity mode with the f32
attention kernels).  Prints per stage: host wall time of an untraced call and of the
traced call, summed device time of the traced call, the device's idle share
over the traced call (1 - device time / its wall time; one stream, so
kernels do not overlap) and the kernels
that take the most device time, and the device time of these groups: the
hand kernels, host-to-device copies, and cuBLAS/cuDNN GEMMs.  The full
table goes to ``<out_dir>/profile_<config>.json``.

Run from the repository root on the machine with the GPU:
    python3 tools/profile_torch_port.py [--out_dir profiles] [--config all|<one of CONFIGS>]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


# kernel-name fragments of each reported group (the hand kernels by their
# device-function names, every pass of B2, B3 and B4 included, "::" included
# so that B5's fragment does not match B1's; B4 runs B2's passes under its
# own kernel names).  No hand kernel's name contains
# "gemm", so the library group never counts one of them a second time.
GROUPS = {
    "B1 pflash": ("::pflash_sm90_kernel<",),
    "B2 ln_ffn": ("::ln_ffn_bf16_rows_kernel<", "::ln_ffn_bf16_up_kernel<", "::ln_ffn_bf16_down_kernel<"),
    "B3 ln_ffn_int8": ("::ln_ffn_int8_rows_kernel<", "::ln_ffn_int8_upmax_kernel<", "::ln_ffn_int8_upq_kernel<",
                       "::ln_ffn_int8_down_kernel<"),
    "B4 convnext_dw": ("::convnext_dw_rows_kernel<", "::convnext_dw_up_kernel<", "::convnext_dw_down_kernel<"),
    "B5 flash": ("::flash_sm90_kernel<",),
    "B1 pflash f32": ("::pflash_f32_kernel<",),
    "B5 flash f32": ("::flash_f32_kernel<",),
    "host-to-device copies": ("Memcpy HtoD",),
    "GEMMs": ("gemm", "nvjet"),
}
# launch-count key of each hand-kernel wrapper (before any ":shape") -> its group
LAUNCH_GROUPS = {
    "pflash_attention": "B1 pflash",
    "ln_ffn_bf16": "B2 ln_ffn",
    "ln_ffn_int8": "B3 ln_ffn_int8",
    "convnext_dw": "B4 convnext_dw",
    "flash_attention": "B5 flash",
    "pflash_attention_f32": "B1 pflash f32",
    "flash_attention_f32": "B5 flash f32",
}


def unmatched_groups(launches: dict, groups_ms: dict) -> list:
    """The groups of hand kernels that the traced call launched (by the
    wrappers' launch counts) but that no traced kernel name matched."""
    launched = {LAUNCH_GROUPS[key.split(":")[0]] for key, n in launches.items() if n}
    return sorted(g for g in launched if not groups_ms.get(g))


# configuration name -> AudioCodec arguments
CONFIGS = {
    "fast-int8": {"mode": "fast-int8"},
    "fast": {"mode": "fast"},
    "parity": {"mode": "parity"},
    "flash-dw": {"mode": "fast", "attn_impl": "flash", "vocos_impl": "fused-dw"},
    # fast's B1 attention with B4's Vocos: against "fast", only the Vocos differs
    "fast-dw": {"mode": "fast", "vocos_impl": "fused-dw"},
    # parity with the f32 attention kernels in place of dense attention
    "parity-pflash": {"mode": "parity", "attn_impl": "pflash"},
    "parity-flash": {"mode": "parity", "attn_impl": "flash"},
}


def device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)


def trace_call(torch, fn) -> dict:
    """One untraced call (``wall_ms``) and one call traced with ``torch.profiler``:
    that call's own wall time (``traced_wall_ms``), its device time and the
    device's idle share over the same call (1 - device time / traced wall time;
    one stream, so kernels do not overlap), and its device-side events by name.
    A device time above the traced wall time means the two did not measure the
    same work: ``device_exceeds_wall`` is then true and ``idle_share`` None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): the CPU ops that launched
    # them carry the same time and would count it twice
    rows = [(e.key, device_us(e) / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_us(e) > 0 and not e.key.startswith("Activity Buffer")]
    if not rows:
        raise RuntimeError("the trace holds no device time")
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    exceeds = busy_ms > wall_ms
    return {"wall_ms": plain_wall_ms, "traced_wall_ms": wall_ms, "device_ms": busy_ms,
            "device_over_traced_wall": busy_ms / wall_ms, "device_exceeds_wall": exceeds,
            "idle_share": None if exceeds else 1.0 - busy_ms / wall_ms,
            "device_launches": sum(c for _, _, c in rows),
            "kernels": [{"name": k, "device_ms": ms, "calls": c} for k, ms, c in rows]}


def idle_text(r: dict) -> str:
    if r["device_exceeds_wall"]:
        return f"idle share not measured (device time {r['device_over_traced_wall']:.3f}x the traced wall time)"
    return f"idle share {r['idle_share']:.3f}"


def profile_stage(torch, fn):
    from simwhisper_codec_tpu_torch.ops import _cuda

    _cuda.reset_launch_counts()
    r = trace_call(torch, fn)
    r["groups_ms"] = {g: sum(k["device_ms"] for k in r["kernels"] if any(f in k["name"] for f in frags))
                      for g, frags in GROUPS.items()}
    missing = unmatched_groups(_cuda.launch_counts, r["groups_ms"])
    if missing:
        raise RuntimeError(f"launched but matched by no traced kernel name: {missing} (GROUPS is stale)")
    return r


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out_dir", default="profiles", help="where the per-configuration JSON tables go")
    ap.add_argument("--config", default="all", choices=["all", *CONFIGS])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 2
    from simwhisper_codec_tpu_torch.config import load_config
    from simwhisper_codec_tpu_torch.models.codec import AudioCodec, init_params
    from simwhisper_codec_tpu_torch.ops import _cuda
    from simwhisper_codec_tpu_torch.utils import aot

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[gpu] {gpu}; torch {torch.__version__}", flush=True)
    _cuda.build_kernels()
    cfg = load_config("config/SimWhisperCodec.yaml")
    model = init_params(cfg, torch.Generator().manual_seed(0))
    wav = np.random.default_rng(0).standard_normal((8, cfg.chunk_samples)).astype(np.float32) * 0.1
    lens = np.full(8, cfg.chunk_samples)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in CONFIGS if args.config == "all" else [args.config]:
        codec = AudioCodec(cfg, model, batch_size=8, device="cuda", **CONFIGS[name])
        tok = codec.inference_tokenize(wav, lens)  # warm-up of both stages
        codes, clen = tok["codes"].cpu().numpy(), tok["codes_lengths"].cpu().numpy()
        codec.inference_detokenize(codes, clen)
        result = {"gpu": gpu, "config": name, **CONFIGS[name], "batch": 8, "seconds_per_item": cfg.max_audio_seconds}
        for program in ("graph", "eager"):
            with aot.eager() if program == "eager" else contextlib.nullcontext():
                result[program] = {
                    "tokenize": profile_stage(torch, lambda: codec.inference_tokenize(wav, lens)),
                    "detokenize": profile_stage(torch, lambda: codec.inference_detokenize(codes, clen))}
        (out_dir / f"profile_{name}.json").write_text(json.dumps(result, indent=1))
        for program, stage in ((p, s) for p in ("graph", "eager") for s in ("tokenize", "detokenize")):
            r = result[program][stage]
            print(f"[{name}/{stage}/{program}] wall {r['wall_ms']:.3f} ms (traced {r['traced_wall_ms']:.3f}), "
                  f"device {r['device_ms']:.3f} ms in {r['device_launches']} launches, {idle_text(r)}", flush=True)
            print(f"    groups (ms): {json.dumps({g: round(v, 3) for g, v in r['groups_ms'].items()})}", flush=True)
            for k in r["kernels"][:12]:
                print(f"    {k['device_ms']:9.3f} ms  {k['calls']:5d}x  {k['name'][:110]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
