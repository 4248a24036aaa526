"""Training -> held-out quality: one command, one recorded curve.

Counterpart of ``experiments/codec/quality_curve.py``.  Builds a small
synthetic corpus (24 training voices, 7 held-out voices of seeds disjoint
from the training ones and from the probe's built-in 10000+ voices), trains
the codec GAN from random init at the reduced ``--small`` width through
``python -m simwhisper_codec_tpu_torch.experiments.codec.train`` with the
held-out probe every N steps, and writes the quality-vs-step curve with an
``improved`` flag (STOI +0.05, SI-SNR +3 dB and PESQ-WB +0.2 over the
random-init row).  Exits 1 when held-out quality did not improve.

Run:  python -m simwhisper_codec_tpu_torch.experiments.codec.quality_curve --output_folder qc \\
          --steps 3000 [--report docs/QUALITY_CURVE_H100.json] [trainer arguments]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from simwhisper_codec_tpu_torch.experiments.codec.train import synthetic_voice
from simwhisper_codec_tpu_torch.utils.audio_io import save_audio

REPO_ROOT = Path(__file__).resolve().parents[3]
TRAIN = "simwhisper_codec_tpu_torch.experiments.codec.train"
N_TRAIN, N_HELDOUT = 24, 7


def build_corpus(out: Path, sr: int = 16000):
    """train_data/: voices 0..23; eval_data/: voices 20000..20006 (3 s each)."""
    train_dir, eval_dir = out / "train_data", out / "eval_data"
    train_dir.mkdir(parents=True, exist_ok=True)
    eval_dir.mkdir(parents=True, exist_ok=True)
    for i in range(N_TRAIN):
        save_audio(train_dir / f"voice{i:02d}.wav", synthetic_voice(i, 3.0, sr), sr)
    for i in range(N_HELDOUT):
        save_audio(eval_dir / f"heldout{i}.wav", synthetic_voice(20_000 + i, 3.0, sr), sr)
    return train_dir, eval_dir


def curve_report(run_dir: Path, steps: int, eval_every: int, wall_s: float) -> dict:
    curve = [json.loads(line) for line in (run_dir / "quality_log.jsonl").read_text().splitlines()]
    losses = [json.loads(line) for line in (run_dir / "train_log.jsonl").read_text().splitlines()]
    base, final = curve[0], curve[-1]
    keys = ("stoi", "si_snr", "pesq_wb")
    known = all(base.get(k) is not None and final.get(k) is not None for k in keys)
    return {
        "steps": steps,
        "eval_every": eval_every,
        "wall_s": round(wall_s, 1),
        "train_files": {"synthetic_voices": N_TRAIN},
        "heldout_files": {"synthetic_voices": N_HELDOUT},
        "curve": curve,
        "random_init": base,
        "final": final,
        "improvement": {k: round(final[k] - base[k], 4) for k in keys
                        if base.get(k) is not None and final.get(k) is not None},
        "final_losses": {k: v for k, v in losses[-1].items() if k not in ("step", "time")},
        "improved": known and (final["stoi"] > base["stoi"] + 0.05 and final["si_snr"] > base["si_snr"] + 3.0
                               and final["pesq_wb"] > base["pesq_wb"] + 0.2),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--output_folder", required=True)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--eval_every", type=int, default=None)
    ap.add_argument("--report", default=str(REPO_ROOT / "docs" / "QUALITY_CURVE_H100.json"))
    args, passthrough = ap.parse_known_args(argv)

    out = Path(args.output_folder)
    train_dir, eval_dir = build_corpus(out)
    eval_every = args.eval_every or max(50, args.steps // 12)
    run_dir = out / "run"
    t0 = time.time()
    cmd = [sys.executable, "-m", TRAIN, "--small", "--data_folder", str(train_dir), "--eval_folder", str(eval_dir),
           "--eval_every", str(eval_every), "--output_folder", str(run_dir), "--steps", str(args.steps),
           "--batch_size", "16", "--segment_seconds", "2.0", "--checkpoint_every", str(args.steps),
           "--log_every", str(max(10, eval_every // 2)), *passthrough]
    print("quality_curve:", " ".join(cmd), flush=True)
    rc = subprocess.run(cmd, cwd=REPO_ROOT).returncode
    if rc != 0:
        print(f"quality_curve: training failed (rc {rc})", file=sys.stderr)
        return rc
    report = curve_report(run_dir, args.steps, eval_every, time.time() - t0)
    Path(args.report).parent.mkdir(parents=True, exist_ok=True)
    Path(args.report).write_text(json.dumps(report, indent=1))
    print(json.dumps({k: v for k, v in report.items() if k != "curve"}, indent=1))
    print(f"wrote {args.report} ({len(report['curve'])} curve points)")
    if not report["improved"]:
        print("quality_curve: held-out quality did not improve from random init", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
