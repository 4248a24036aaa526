"""Extract speaker embeddings for a directory of audio files, cached as .npy.

Twin of the JAX package's ``tools/speaker/extract_spk_emb.py`` (reference
``tools/speaker/extract_spk_emb.py:38-94``): walks a directory, embeds the
utterances with ``spk_sim_cal.load_extractor``, 128 a batched call, and
caches one ``<utt>.npy`` a file, skipping files already embedded.  A file
that cannot be decoded is skipped; an error of the embedder propagates.
Runs on ``cuda`` unless ``--device cpu``.

Run:  python -m simwhisper_codec_tpu_torch.tools.speaker.extract_spk_emb \\
          --input_dir A --emb_dir E [--ecapa_checkpoint wavlm_large_finetune.pth]
"""

import argparse
from pathlib import Path

import numpy as np

from simwhisper_codec_tpu_torch.eval.speaker import PAIRS_PER_CALL
from simwhisper_codec_tpu_torch.tools.speaker.spk_sim_cal import load_extractor
from simwhisper_codec_tpu_torch.utils.audio_io import find_audio_files, load_audio

ROWS_PER_CALL = 2 * PAIRS_PER_CALL  # rows of one batched call, as SIM's


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input_dir", required=True)
    p.add_argument("--emb_dir", required=True)
    p.add_argument("--ecapa_checkpoint", default=None)
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = p.parse_args(argv)

    extractor = load_extractor(args.ecapa_checkpoint, device=args.device)

    out = Path(args.emb_dir)
    out.mkdir(parents=True, exist_ok=True)
    done = 0
    pending = []  # (target, waveform) of the next batched call

    def flush():
        for (target, _), emb in zip(pending, extractor.embed_batch([w for _, w in pending], args.sample_rate)):
            np.save(target, emb)
        pending.clear()

    for path in find_audio_files(args.input_dir):
        target = out / (Path(path).stem + ".npy")
        if target.exists():
            continue
        try:
            wav = load_audio(path, target_sample_rate=args.sample_rate)
        except Exception as e:  # per-file resilience for unreadable audio (extract_spk_emb.py pattern)
            print(f"skipping {path}: {e}")
            continue
        pending.append((target, wav))
        done += 1
        if len(pending) == ROWS_PER_CALL:
            flush()
    flush()
    print(f"embedded {done} new utterances into {out}")


if __name__ == "__main__":
    main()
