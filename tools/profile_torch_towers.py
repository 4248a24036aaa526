#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's three metric towers on one GPU.

Builds each tower at its published width with random weights from a fixed
seed (HuBERT-large CTC for WER, wav2vec2-base + BiLSTM for UTMOS,
WavLM-large + ECAPA-TDNN for speaker similarity), warms it on one
utterance (which captures its program, ``utils/aot.py``), then traces one
call, a replay, on a 6 s utterance padded to its 8 s bucket (one utterance
a call, as the report's wrappers run them) with
``torch.profiler``, with TF32 off (the default) and on.  Prints per tower
and setting: host wall time of an untraced call and of the traced call,
summed device time of the traced call, the device's idle share over the
traced call (``profile_torch_port.trace_call``) and device time by kernel group (convolutions, GEMMs, the LSTM, softmax,
the rest), and the kernels that take the most device time.  Then the
large towers' positional conv alone (grouped k = 128, 16 groups, at the 8 s
bucket's 399 frames) three ways, CUDA events over 20 calls: cuDNN as the
towers run it, cuDNN with ``benchmark`` autotuning, and one batched GEMM
over the unfolded input (not used by the towers; an ablation).  The full
tables go to ``<out_dir>/profile_towers.json``.

Run from the repository root on the machine with the GPU:
    python3 tools/profile_torch_towers.py [--out_dir profiles] [--seconds 6.0]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from profile_torch_port import idle_text, trace_call  # noqa: E402  (this script's own directory)

# kernel-name fragments of each group, matched in this order (cuDNN's
# convolution kernels carry "gemm" in some names, so convolutions go first)
GROUPS = (
    ("convolutions", ("conv", "fprop", "implicit", "winograd", "fft")),
    ("LSTM", ("rnn", "lstm", "RNN", "LSTM", "persist")),
    ("GEMMs", ("gemm", "nvjet", "cutlass", "xmma")),
    ("softmax", ("softmax",)),
)


def group_of(name: str) -> str:
    for group, frags in GROUPS:
        if any(f in name for f in frags):
            return group
    return "other"


def profile_call(torch, fn) -> dict:
    r = trace_call(torch, fn)
    r["groups_ms"] = {}
    for k in r["kernels"]:
        g = group_of(k["name"])
        r["groups_ms"][g] = r["groups_ms"].get(g, 0.0) + k["device_ms"]
    return r


def event_ms(torch, fn, iters: int = 20) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def pos_conv_variants(torch, precision: str) -> dict:
    """The 24 x 1024 towers' positional conv at 399 frames: ms a call three
    ways, and the unfolded GEMM's max |d| from cuDNN's output."""
    from torch.nn import functional as F

    from simwhisper_codec_tpu_torch.models.codec import f32_precision

    d, k, g, t = 1024, 128, 16, 399
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(1, d, t, generator=gen).cuda()
    w = (torch.randn(d, d // g, k, generator=gen) * 0.02).cuda()
    b = torch.zeros(d).cuda()

    def cudnn():
        return F.conv1d(x, w, b, padding=k // 2, groups=g)

    def unfolded():  # (g, t + 1, cin_g * k) @ (g, cin_g * k, cout_g)
        cols = F.pad(x, (k // 2, k // 2)).unfold(2, k, 1)  # (1, d, t + 1, k)
        cols = cols.reshape(g, d // g, t + 1, k).permute(0, 2, 1, 3).reshape(g, t + 1, d // g * k)
        wg = w.reshape(g, d // g, d // g * k).transpose(1, 2)
        return (torch.bmm(cols, wg).permute(0, 2, 1).reshape(1, d, t + 1) + b[:, None])

    with torch.no_grad(), f32_precision(precision):
        out = {"cudnn_ms": event_ms(torch, cudnn)}
        prev = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = True
        try:
            out["cudnn_benchmark_ms"] = event_ms(torch, cudnn)
        finally:
            torch.backends.cudnn.benchmark = prev
        out["unfolded_bmm_ms"] = event_ms(torch, unfolded)
        out["unfolded_max_abs_diff"] = float((unfolded() - cudnn()).abs().max())
    out["gflop"] = 2 * d * (d // g) * k * (t + 1) / 1e9
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out_dir", default="profiles", help="where the JSON table goes")
    ap.add_argument("--seconds", type=float, default=6.0, help="utterance length")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_towers: no CUDA device", file=sys.stderr)
        return 2
    from simwhisper_codec_tpu_torch.eval.speaker import SpeakerEmbedder, init_ecapa
    from simwhisper_codec_tpu_torch.eval.utmos import UTMOSConfig, UTMOSScorer, init_utmos_params
    from simwhisper_codec_tpu_torch.eval.wer import CTCTranscriber
    from simwhisper_codec_tpu_torch.models.ssl import hubert_large_ft_config, init_ssl_params, wavlm_large_config

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[gpu] {gpu}; torch {torch.__version__}", flush=True)
    gen = torch.Generator().manual_seed(0)
    hubert = hubert_large_ft_config()
    towers = {
        "wer": CTCTranscriber(params={"ssl": init_ssl_params(hubert, gen),
                                      "lm_head": {"w": torch.randn(32, hubert.d_model, generator=gen) * 0.03,
                                                  "b": torch.zeros(32)}},
                              cfg=hubert, vocab={i: chr(65 + i) for i in range(32)}, device="cuda"),
        "utmos": UTMOSScorer(params=init_utmos_params(UTMOSConfig(), gen), device="cuda"),
        "speaker_sim": SpeakerEmbedder(init_ecapa(gen), "wavlm_large", init_ssl_params(wavlm_large_config(), gen),
                                       device="cuda"),
    }
    calls = {"wer": "transcribe", "utmos": "score", "speaker_sim": "embed"}
    wav = (np.random.default_rng(1).standard_normal(int(args.seconds * 16000)) * 0.1).astype(np.float32)
    result = {"gpu": gpu, "utterance_seconds": args.seconds, "towers": {}}
    for name, tower in towers.items():
        fn = getattr(tower, calls[name])
        for precision in ("highest", "default"):
            tower.precision = precision
            fn(wav)  # warm-up: captures this precision's program (cuDNN plans, the relative-position buckets)
            r = profile_call(torch, lambda: fn(wav))
            result["towers"][f"{name}/{precision}"] = r
            print(f"[{name}/{'TF32 off' if precision == 'highest' else 'TF32 on'}] wall {r['wall_ms']:.3f} ms "
                  f"(traced {r['traced_wall_ms']:.3f}), device {r['device_ms']:.3f} ms in {r['device_launches']} "
                  f"launches, {idle_text(r)}; {r['wall_ms'] / args.seconds:.3f} ms per audio s", flush=True)
            print(f"    groups (ms): {json.dumps({g: round(v, 3) for g, v in r['groups_ms'].items()})}", flush=True)
            for k in r["kernels"][:8]:
                print(f"    {k['device_ms']:9.3f} ms  {k['calls']:5d}x  {k['name'][:110]}", flush=True)
    for precision in ("highest", "default"):
        r = result[f"pos_conv/{precision}"] = pos_conv_variants(torch, precision)
        print(f"[pos conv/{'TF32 off' if precision == 'highest' else 'TF32 on'}] {json.dumps(r)}", flush=True)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "profile_towers.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
