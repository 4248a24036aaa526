"""UTMOS MOS prediction over a directory of audio files.

Twin of the JAX package's ``tools/utmos/calculate_utmos.py`` (reference
``tools/utmos/calculate_utmos.py:1-27``), the model run on the device by
``eval/utmos.py`` (f32, TF32 off) instead of fairseq / pytorch-lightning.
Only the published ``utmos22_strong`` checkpoint file is required; without
it the tool exits with code 2.  A file that cannot be decoded is skipped;
an error of the scorer propagates.  Runs on ``cuda`` unless
``--device cpu``.

Run:  python -m simwhisper_codec_tpu_torch.tools.utmos.calculate_utmos \\
          --input_dir A --ckpt weights/utmos22_strong.ckpt
"""

import argparse
import sys
from pathlib import Path


def have_utmos(ckpt_path: str) -> bool:
    """The checkpoint is the only hard gate (zero-egress: cannot download)."""
    return Path(ckpt_path).exists()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input_dir", type=str, required=True)
    parser.add_argument("--ckpt", type=str, default="./weights/utmos22_strong.ckpt")
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--device", type=str, default="cuda", help="torch device (cuda or cpu)")
    args = parser.parse_args(argv)

    if not have_utmos(args.ckpt):
        print(
            "UTMOS checkpoint not found (zero-egress: cannot auto-download). "
            f"Place the utmos22_strong lightning .ckpt at {args.ckpt}; the "
            "model itself runs natively in PyTorch (no fairseq needed)."
        )
        sys.exit(2)

    import numpy as np

    from simwhisper_codec_tpu_torch.tools.utmos.utmos_model import UTMOSScorer
    from simwhisper_codec_tpu_torch.utils.audio_io import find_audio_files, load_audio

    scorer = UTMOSScorer(args.ckpt, device=args.device)
    scores = []
    for path in find_audio_files(args.input_dir):
        try:
            wav = load_audio(path, target_sample_rate=args.sample_rate)
        except Exception as e:  # per-file resilience for unreadable audio (reference eval-loop semantics)
            print(f"skipping {path}: {e}")
            continue
        scores.append(scorer.score(wav, 16000))
    print(f"UTMOS mean over {len(scores)} files: {np.mean(scores):.3f}")


if __name__ == "__main__":
    main()
