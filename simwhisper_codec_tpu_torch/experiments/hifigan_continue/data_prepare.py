"""LJSpeech-style data preparation: scan, filter, split, JSON manifests.

Counterpart of ``experiments/hifigan_continue/data_prepare.py`` (reference
``hifigan_continue_whisper/data_prepare.py:25-206``): walk the corpus, drop
utterances shorter than 1 s or below 1e-4 peak, split train/valid/test
80/10/10 with a seeded permutation, write ``<split>.json`` manifests keyed by
utterance id (wav path and duration).  A fingerprint file of the settings
makes a second call with the same settings a no-op.

Run:  python -m simwhisper_codec_tpu_torch.experiments.hifigan_continue.data_prepare \\
          --data_folder wavs --save_folder save
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict

import numpy as np

from simwhisper_codec_tpu_torch.utils.audio_io import find_audio_files, load_audio


def prepare_dataset(
    data_folder: str,
    save_folder: str,
    splits=("train", "valid", "test"),
    ratios=(0.8, 0.1, 0.1),
    min_duration: float = 1.0,
    silence_threshold: float = 1e-4,
    sample_rate: int = 16000,
    seed: int = 42,
) -> Dict[str, str]:
    """Scan -> filter -> split -> write ``<save_folder>/<split>.json``; returns split -> path."""
    save = Path(save_folder)
    save.mkdir(parents=True, exist_ok=True)
    fingerprint = hashlib.sha256(
        json.dumps([data_folder, list(splits), list(ratios), min_duration, seed]).encode()
    ).hexdigest()[:16]
    guard = save / f".prep_{fingerprint}"
    manifest_paths = {s: str(save / f"{s}.json") for s in splits}
    if guard.exists() and all(Path(p).exists() for p in manifest_paths.values()):
        return manifest_paths

    records = []
    for path in find_audio_files(data_folder):
        wav = load_audio(path, target_sample_rate=sample_rate)
        duration = len(wav) / sample_rate
        if duration < min_duration or float(np.abs(wav).max()) < silence_threshold:
            continue
        records.append({"id": Path(path).stem, "wav": str(path), "duration": duration})

    order = np.random.default_rng(seed).permutation(len(records))
    bounds = np.cumsum([int(r * len(records)) for r in ratios[:-1]])
    for split, idx in zip(splits, np.split(order, bounds)):
        manifest = {records[i]["id"]: records[i] for i in idx}
        Path(manifest_paths[split]).write_text(json.dumps(manifest, indent=2))
    guard.touch()
    return manifest_paths


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_folder", required=True)
    p.add_argument("--save_folder", required=True)
    args = p.parse_args()
    print(json.dumps(prepare_dataset(args.data_folder, args.save_folder), indent=2))
