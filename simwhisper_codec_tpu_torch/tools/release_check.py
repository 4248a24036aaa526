"""One-command real-weight readiness drill.

Twin of the JAX package's ``tools/release_check.py``, on the port.  Given
the codec checkpoint (+ optional tower checkpoints), this runs:

  1. load    — read the reference ``.pt`` into ``SimWhisperCodec`` (the port
               reads ``.pt`` directly, so there is nothing to convert) and
               write its per-tensor checksum report to
               ``<workdir>/checksums.txt``
  2. parity  — real-weight encode/decode vs the torch oracle, bit-exact
               codes across the chunk loop (needs the upstream reference
               checkout, named by ``--reference_root``; skipped without it;
               the load surface certified: audiocodec/model.py:375-396)
  3. bench   — recorded as skipped: the port has no bench yet (ROADMAP A.1)
  4. corpus  — ``python -m simwhisper_codec_tpu_torch.eval_corpus
               --full-report`` over a synthetic corpus with the weights and
               the metric towers (no gated metric), in its default mode

and emits a single readiness JSON; exits 1 when not ready.  ``--dry_run``
writes a full-width random reference-layout ``.pt`` (``SimWhisperCodec``,
seed 0) and, unless tower checkpoints are given, the three synthetic towers
(``tools/make_synthetic_tower_weights``), and runs the identical pipeline:
the drill that proves the command works before the weights exist.  Runs on
``cuda`` unless ``--device cpu``.

Run:  python -m simwhisper_codec_tpu_torch.tools.release_check --codec_checkpoint weights/SimWhisperCodec.pt \\
          [--asr_model D --utmos_checkpoint F --ecapa_checkpoint F] \\
          [--reference_root R] [--workdir W] [--skip parity] [--corpus_n 12]
      python -m simwhisper_codec_tpu_torch.tools.release_check --dry_run   # synthetic everything
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[2]
BENCH_SKIP = "the port has no bench yet (ROADMAP A.1: a benchmark issue adds it and its BENCHMARK.json cell)"
# the report's numbers that the readiness JSON carries
QUALITY_KEYS = ("stoi", "pesq_wb", "pesq_nb", "si_snr", "snr", "lsd", "mcd", "wer_rec", "utmos_rec",
                "speaker_sim", "bitrate_bps")


def add_reference_to_path(reference_root) -> bool:
    """Make the upstream reference checkout at ``reference_root`` importable
    as an oracle; returns whether it was given and is mounted.  Its ``audiocodec/nn/modules.py`` imports
    torchaudio for two mel helpers that the codec classes never call; where
    torchaudio is absent a minimal stand-in provides them."""
    if not reference_root or not Path(reference_root).is_dir():
        return False
    reference_root = str(Path(reference_root).resolve())
    if reference_root not in sys.path:
        sys.path.insert(0, reference_root)
    try:
        import torchaudio  # noqa: F401
    except ImportError:
        _install_torchaudio_shim()
    return True


def _install_torchaudio_shim() -> None:
    import importlib.machinery
    import math
    import types

    ta = types.ModuleType("torchaudio")
    functional = types.ModuleType("torchaudio.functional")
    inner = types.ModuleType("torchaudio.functional.functional")

    def _hz_to_mel(freq, mel_scale="htk"):
        return 2595.0 * math.log10(1.0 + freq / 700.0)

    def _mel_to_hz(mels, mel_scale="htk"):
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)

    for mod in (ta, functional, inner):
        mod.__spec__ = importlib.machinery.ModuleSpec(mod.__name__, loader=None)
    inner._hz_to_mel = _hz_to_mel
    inner._mel_to_hz = _mel_to_hz
    functional.functional = inner
    ta.functional = functional
    sys.modules["torchaudio"] = ta
    sys.modules["torchaudio.functional"] = functional
    sys.modules["torchaudio.functional.functional"] = inner


def _run(cmd, timeout=7200):
    proc = subprocess.run(cmd, cwd=REPO_ROOT, capture_output=True, text=True, timeout=timeout)
    return proc.returncode, (proc.stdout + proc.stderr)[-3000:]


def stage_load(args, work: Path) -> dict:
    from simwhisper_codec_tpu_torch.config import load_config
    from simwhisper_codec_tpu_torch.models.codec import SimWhisperCodec
    from simwhisper_codec_tpu_torch.utils.checkpoint import load_reference_checkpoint, param_checksum_report

    model = load_reference_checkpoint(SimWhisperCodec(load_config(args.config)), args.codec_checkpoint)
    out = work / "checksums.txt"
    out.write_text(param_checksum_report(model) + "\n")
    return {"ok": True, "checksums": str(out), "tensors": len(model.state_dict()),
            "parameters": sum(p.numel() for p in model.parameters())}


def stage_parity(args) -> dict:
    """Real-weight parity: both sides load the SAME .pt; codes must be
    bit-exact across the chunk loop, waveforms within fp tolerance."""
    if not add_reference_to_path(args.reference_root):
        return {"ok": None, "skipped": "reference repo not mounted"}
    import torch
    import yaml

    from audiocodec.model import AudioCodec as RefCodec

    from simwhisper_codec_tpu_torch.models.codec import AudioCodec

    with open(args.config) as f:
        gp = yaml.safe_load(f)["generator_params"]
    gp["acoustic_encoder"]["freeze"] = False
    gp.pop("init_from_whisper", None)
    gp.pop("whisper_model_path", None)

    ref = RefCodec(gp)
    sd = torch.load(args.codec_checkpoint, map_location="cpu", weights_only=False)
    ref.load_state_dict(sd.get("model", sd))
    ref = ref.eval()
    ours = AudioCodec.load_from_checkpoint(args.config, args.codec_checkpoint, batch_size=2, mode="parity",
                                           device=args.device)

    rng = np.random.default_rng(20)
    wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32)
            for n in (33 * 16000, 213000)]  # chunk loop + partial chunk
    with torch.no_grad():
        ref_enc = ref.encode([torch.from_numpy(w) for w in wavs], overlap_seconds=10, device=torch.device("cpu"))
    our_enc = ours.encode(wavs, overlap_seconds=10)
    mismatch = 0
    for rc_, oc in zip(ref_enc["codes_list"], our_enc["codes_list"]):
        assert rc_.numpy().shape == np.asarray(oc).shape
        mismatch += int((rc_.numpy() != np.asarray(oc)).sum())

    with torch.no_grad():
        ref_dec = ref.decode(ref_enc["codes_list"], overlap_seconds=10, device=torch.device("cpu"))
    our_dec = ours.decode(our_enc["codes_list"], overlap_seconds=10)
    wav_err = max(float(np.max(np.abs(r.numpy() - np.asarray(o))))
                  for r, o in zip(ref_dec["syn_wav_list"], our_dec["syn_wav_list"]))
    return {"ok": mismatch == 0 and wav_err < 2e-2,
            "code_mismatches": mismatch, "max_wav_abs_err": round(wav_err, 6)}


def stage_bench(args) -> dict:
    return {"ok": None, "skipped": BENCH_SKIP}


def stage_corpus(args, work: Path) -> dict:
    report = work / "corpus_report.json"
    cmd = [sys.executable, "-m", "simwhisper_codec_tpu_torch.eval_corpus",
           "--config_path", args.config,
           "--checkpoint_path", args.codec_checkpoint,
           "--synthetic", str(args.corpus_n),
           "--output_dir", str(work / "corpus_out"),
           "--report_json", str(report), "--full-report",
           "--device", args.device]
    for flag, val in (("--asr_model", args.asr_model),
                      ("--utmos_checkpoint", args.utmos_checkpoint),
                      ("--ecapa_checkpoint", args.ecapa_checkpoint)):
        if val:
            cmd += [flag, val]
    rc, log = _run(cmd)
    rep = json.loads(report.read_text()) if report.exists() else None
    status = (rep or {}).get("gated_metrics") or {}
    gated = sorted(k for k, v in status.items() if v.startswith("gated"))
    flat = {**(rep or {}), **(rep or {}).get("quality", {}), **(rep or {}).get("towers", {})}
    return {"ok": rc == 0 and rep is not None and not gated,
            "gated_metrics": gated, "report": str(report),
            "quality": {k: flat[k] for k in QUALITY_KEYS if k in flat},
            **({} if rc == 0 else {"log_tail": log[-800:]})}


def synthesize_checkpoints(args, work: Path) -> None:
    """--dry_run: a full-geometry random checkpoint in the reference layout
    and, unless tower checkpoints were given, the three synthetic towers."""
    import torch

    from simwhisper_codec_tpu_torch.config import load_config
    from simwhisper_codec_tpu_torch.models.codec import init_params
    from simwhisper_codec_tpu_torch.tools import make_synthetic_tower_weights as towers_tool

    pt = work / "SimWhisperCodec.synthetic.pt"
    model = init_params(load_config(args.config), torch.Generator().manual_seed(0))
    torch.save({"model": model.state_dict()}, pt)
    args.codec_checkpoint = str(pt)

    towers = work / "tower_weights"
    if not (args.asr_model or args.utmos_checkpoint or args.ecapa_checkpoint):
        towers.mkdir(parents=True, exist_ok=True)
        towers_tool.make_hubert_ctc(towers / "hubert_ctc", 0)
        towers_tool.make_utmos(towers / "utmos22_strong.ckpt", 0)
        towers_tool.make_wavlm_ecapa(towers / "wavlm_large_finetune.pth", 0)
        args.asr_model = str(towers / "hubert_ctc")
        args.utmos_checkpoint = str(towers / "utmos22_strong.ckpt")
        args.ecapa_checkpoint = str(towers / "wavlm_large_finetune.pth")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--codec_checkpoint", default=None)
    ap.add_argument("--config", default="config/SimWhisperCodec.yaml")
    ap.add_argument("--asr_model", default=None)
    ap.add_argument("--utmos_checkpoint", default=None)
    ap.add_argument("--ecapa_checkpoint", default=None)
    ap.add_argument("--reference_root", default=None,
                    help="the upstream reference checkout the parity stage holds the port to "
                         "(the stage is skipped without it)")
    ap.add_argument("--workdir", default=str(Path(tempfile.gettempdir()) / "release_check"))
    ap.add_argument("--corpus_n", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the parity and corpus stages (cuda or cpu)")
    ap.add_argument("--skip", default="",
                    help="comma list from {load,parity,bench,corpus}")
    ap.add_argument("--dry_run", action="store_true",
                    help="synthesize all checkpoints (readiness drill)")
    ap.add_argument("--out", default=None,
                    help="readiness JSON (default <workdir>/READINESS.json)")
    args = ap.parse_args(argv)

    args.config = str(REPO_ROOT / args.config)  # an absolute path stays as it is
    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    if args.dry_run:
        synthesize_checkpoints(args, work)
    if not args.codec_checkpoint:
        ap.error("--codec_checkpoint required (or --dry_run)")

    skip = {s.strip() for s in args.skip.split(",") if s.strip()}
    stages = {"load": lambda: stage_load(args, work),
              "parity": lambda: stage_parity(args),
              "bench": lambda: stage_bench(args),
              "corpus": lambda: stage_corpus(args, work)}
    results = {"codec_checkpoint": args.codec_checkpoint,
               "dry_run": args.dry_run, "stages": {}}
    for name, fn in stages.items():
        if name in skip:
            results["stages"][name] = {"ok": None, "skipped": "--skip"}
            continue
        t0 = time.time()
        try:
            r = fn()
        except Exception as e:  # a stage failure must not hide the others
            r = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        r["wall_s"] = round(time.time() - t0, 1)
        results["stages"][name] = r
        print(f"[{name}] {json.dumps(r)[:400]}", flush=True)

    ran = [r for r in results["stages"].values() if r["ok"] is not None]
    results["ready"] = bool(ran) and all(r["ok"] for r in ran)
    out = Path(args.out or work / "READINESS.json")
    out.write_text(json.dumps(results, indent=1))
    print(json.dumps({"ready": results["ready"],
                      "stages": {k: v["ok"] for k, v in results["stages"].items()}}))
    print(f"wrote {out}")
    sys.exit(0 if results["ready"] else 1)


if __name__ == "__main__":
    main()
