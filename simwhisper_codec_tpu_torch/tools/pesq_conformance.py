"""PESQ conformance harness: native P.862 vs the ITU wrapper, on real speech.

Twin of the JAX package's ``tools/pesq_conformance.py`` on the port's numpy
copy of the native P.862 (``eval/pesq_native.py``).  The reference scores
with the pip ``pesq`` wrapper around the ITU C code
(reference ``tools/base_eval/evaluator.py:36-59``); the native
implementation derives its Bark/threshold tables from published
psychoacoustic formulas, so its deviation from ITU PESQ must be *measured*,
not assumed.  This tool builds a deterministic suite of speech-like pairs
and scores every pair with the native implementation and — wherever the pip
package is importable — with ITU PESQ, recording the per-pair scores and
the deviation statistics.

Suite composition (all deterministic):
  * carriers: the real ground-truth speech published with the reference demo
    page (docs/assets/codec/gt_sample*.wav of the reference checkout named
    by ``--reference_root``), else a synthetic formant-modulated voice,
  * a degradation matrix over each carrier: identity, AWGN at an SNR ladder,
    lowpass shelves, uniform quantization, peak clipping, level shifts, and a
    constant delay — the distortion families P.862 was validated on that a
    waveform codec can produce,
  * real codec reconstruction pairs: (gt, <codec>_sample*.wav) for every codec
    family published on the demo page (simwhisper, dac, encodec, mimi,
    speechtokenizer, xcodec) when the reference checkout is given.

The report goes to ``docs/torch/PESQ_CONFORMANCE.json`` by default; the JAX
package's record (``docs/PESQ_CONFORMANCE.json``) is never overwritten.

Run:  python -m simwhisper_codec_tpu_torch.tools.pesq_conformance [--reference_root R] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[2]
# the JAX package's records, which the twins never overwrite
JAX_RECORDS = tuple(REPO_ROOT / "docs" / f"PESQ_{name}.json" for name in ("CONFORMANCE", "CALIBRATION"))

REFERENCE_HELP = ("the upstream reference checkout whose demo-page audio (docs/assets/codec) gives the "
                  "carriers and codec pairs; a synthetic carrier without it")
CODEC_FAMILIES = ("simwhisper", "dac", "encodec", "mimi", "speechtokenizer", "xcodec")


def synthetic_voice(seconds: float = 4.0, sr: int = 16000, seed: int = 7) -> np.ndarray:
    """Formant-modulated harmonic carrier + breath noise (speech-like)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 110.0 * (1.0 + 0.08 * np.sin(2 * np.pi * 2.1 * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = np.zeros_like(t)
    for k, amp in ((1, 1.0), (2, 0.6), (3, 0.45), (4, 0.3), (6, 0.18), (8, 0.1)):
        x += amp * np.sin(k * phase)
    # slow formant-like AM + syllabic gating
    x *= 0.6 + 0.4 * np.sin(2 * np.pi * 3.3 * t + 1.0)
    gate = np.clip(np.sin(2 * np.pi * 1.7 * t) * 4.0, 0.0, 1.0)
    x = x * gate + 0.01 * rng.standard_normal(len(t))
    return (0.25 * x / np.max(np.abs(x))).astype(np.float64)


def ref_assets(reference_root) -> Path:
    """The demo-page audio of the upstream reference checkout at
    ``reference_root`` (None without one)."""
    return Path(reference_root) / "docs" / "assets" / "codec" if reference_root else None


def load_carriers(sr: int = 16000, assets: Path = None) -> dict:
    """Real demo-page speech from ``assets`` when present, synthetic
    fallback otherwise."""
    from simwhisper_codec_tpu_torch.utils.audio_io import load_audio

    carriers = {}
    if assets and assets.is_dir():
        for i in (1, 2, 3, 4):
            p = assets / f"gt_sample{i}.wav"
            if p.exists():
                carriers[f"gt{i}"] = np.asarray(load_audio(p, sr), np.float64)
    if not carriers:
        carriers["synthetic"] = synthetic_voice(sr=sr)
    return carriers


def degradations(x: np.ndarray, sr: int) -> dict:
    """Deterministic degradation matrix over one carrier."""
    rng = np.random.default_rng(0xC0DEC)
    noise = rng.standard_normal(len(x))
    out = {"identity": x.copy()}
    for snr in (40, 30, 20, 10, 5):
        out[f"awgn_{snr}dB"] = x + noise * (np.std(x) + 1e-12) * 10 ** (-snr / 20)
    for fc in (3400, 2000, 1000):
        spec = np.fft.rfft(x)
        f = np.fft.rfftfreq(len(x), 1.0 / sr)
        gain = 1.0 / (1.0 + (f / fc) ** 8)  # 4th-order-like butterworth shelf
        out[f"lowpass_{fc}Hz"] = np.fft.irfft(spec * gain, len(x))
    for bits in (8, 5, 3):
        q = 2.0 ** (bits - 1)
        peak = np.max(np.abs(x)) + 1e-12
        out[f"quant_{bits}bit"] = np.round(x / peak * q) / q * peak
    for frac, name in ((0.5, "clip_50pct"), (0.25, "clip_25pct")):
        peak = np.max(np.abs(x)) + 1e-12
        out[name] = np.clip(x, -frac * peak, frac * peak)
    out["level_-10dB"] = x * 10 ** (-10 / 20)
    out["level_+6dB"] = x * 10 ** (6 / 20)
    d = int(0.008 * sr)
    out["delay_8ms"] = np.concatenate([np.zeros(d), x[:-d]])
    return out


def build_suite(sr: int = 16000, assets: Path = None) -> list:
    """[(pair_id, ref, deg)] — degradation matrix + real codec pairs."""
    from simwhisper_codec_tpu_torch.utils.audio_io import load_audio

    suite = []
    carriers = load_carriers(sr, assets)
    for cname, x in carriers.items():
        for dname, y in degradations(x, sr).items():
            suite.append((f"{cname}/{dname}", x, y))
    if assets and assets.is_dir():
        for fam in CODEC_FAMILIES:
            for i in (1, 2, 3, 4):
                gt = assets / f"gt_sample{i}.wav"
                rec = assets / f"{fam}_sample{i}.wav"
                if gt.exists() and rec.exists():
                    ref = np.asarray(load_audio(gt, sr), np.float64)
                    deg = np.asarray(load_audio(rec, sr), np.float64)
                    m = min(len(ref), len(deg))
                    suite.append((f"codec/{fam}_sample{i}", ref[:m], deg[:m]))
    return suite


def score_suite(suite, modes=("wb", "nb"), sr: int = 16000) -> dict:
    from simwhisper_codec_tpu_torch.eval.pesq_native import pesq as native_pesq

    try:
        from pesq import pesq as itu_pesq
    except ImportError:
        itu_pesq = None

    pairs = {}
    for pair_id, ref, deg in suite:
        entry = {}
        for mode in modes:
            entry[f"native_{mode}"] = round(float(native_pesq(sr, ref, deg, mode)), 4)
            if itu_pesq is not None:
                from simwhisper_codec_tpu_torch.utils.audio_io import resample

                rate = 16000 if mode == "wb" else 8000
                r = resample(ref.astype(np.float32), sr, rate).astype(np.float64)
                d = resample(deg.astype(np.float32), sr, rate).astype(np.float64)
                entry[f"itu_{mode}"] = round(float(itu_pesq(rate, r, d, mode)), 4)
        pairs[pair_id] = entry

    report = {
        "suite_pairs": len(pairs),
        "itu_available": itu_pesq is not None,
        "calibration_caveats": [
            "absolute scale is anchored without pip pesq via in-repo "
            "fixture codecs (G.711/G.726/MNRU) + the published corpus "
            "averages: see docs/PESQ_CALIBRATION.json.  Post-anchor state: "
            "vocoded/codec reconstructions read in the published ITU "
            "operating range (demo simwhisper ~3.3 WB vs the 2.72 "
            "test-clean corpus average + showcase margin) via the "
            "waveform-coherence regime term (pesq_native.py docstring); "
            "G.711 and G.726-40/32 NB anchors sit inside their literature "
            "ranges (max +0.07), G.726-24/16 still read +0.21/+0.35 above "
            "range top.  Documented bound: |native - literature| <= 0.1 at "
            "toll quality, <= 0.35 at low-rate ADPCM; speech+AWGN keeps "
            "the recorded 0.35 ITU tolerance.",
        ],
        "pairs": pairs,
    }
    if itu_pesq is not None:
        stats = {}
        for mode in modes:
            nat = np.array([v[f"native_{mode}"] for v in pairs.values()])
            itu = np.array([v[f"itu_{mode}"] for v in pairs.values()])
            diff = np.abs(nat - itu)
            rank = lambda a: np.argsort(np.argsort(a))
            rn, ri = rank(nat).astype(float), rank(itu).astype(float)
            spearman = float(np.corrcoef(rn, ri)[0, 1])
            stats[mode] = {
                "max_abs_dev": round(float(diff.max()), 4),
                "mean_abs_dev": round(float(diff.mean()), 4),
                "median_abs_dev": round(float(np.median(diff)), 4),
                "pearson": round(float(np.corrcoef(nat, itu)[0, 1]), 4),
                "spearman": round(spearman, 4),
            }
        report["deviation"] = stats
    return report


def out_path(ap: argparse.ArgumentParser, out: str) -> Path:
    """``--out``, refused where it would overwrite a record of the JAX package."""
    path = Path(out)
    if path.resolve() in [p.resolve() for p in JAX_RECORDS]:
        ap.error(f"{out} is the JAX package's record; write the port's elsewhere (default docs/torch/)")
    path.parent.mkdir(parents=True, exist_ok=True)
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO_ROOT / "docs" / "torch" / "PESQ_CONFORMANCE.json"))
    ap.add_argument("--reference_root", default=None, help=REFERENCE_HELP)
    args = ap.parse_args(argv)
    out = out_path(ap, args.out)
    report = score_suite(build_suite(assets=ref_assets(args.reference_root)))
    out.write_text(json.dumps(report, indent=1))
    summary = {k: v for k, v in report.items() if k != "pairs"}
    print(json.dumps(summary, indent=1))
    print(f"wrote {args.out} ({report['suite_pairs']} pairs)")


if __name__ == "__main__":
    main()
