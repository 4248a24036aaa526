"""Pairwise quality metrics with the reference evaluator's API shape.

A copy of ``tools/base_eval/evaluator.py:21-80`` (reference
``tools/base_eval/evaluator.py:13-101``): every metric of one (reference,
degraded) pair after length-matching and clipping to [-1, 1], and their
mean over a corpus.  ``eval_corpus.py --full-report`` and the trainer's
held-out probe score through it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from simwhisper_codec_tpu_torch.eval import metrics as M


def _prepare(ref: np.ndarray, deg: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    m = min(len(ref), len(deg))
    return np.clip(ref[:m], -1, 1), np.clip(deg[:m], -1, 1)


def pair_metrics(ref: np.ndarray, deg: np.ndarray, sample_rate: int = 16000) -> dict:
    """stoi / pesq_wb / pesq_nb / si_snr / snr / lsd / mcd of one pair (a PESQ
    entry is None for an unscorable pair)."""
    ref, deg = _prepare(ref, deg)
    return {
        "stoi": M.stoi(ref, deg, sample_rate),
        "pesq_wb": M.pesq_score(ref, deg, sample_rate, "wb"),
        "pesq_nb": M.pesq_score(ref, deg, sample_rate, "nb"),
        "si_snr": M.si_snr(ref, deg),
        "snr": M.snr(ref, deg),
        "lsd": M.log_spectral_distance(ref, deg),
        "mcd": M.mel_cepstral_distortion(ref, deg, sample_rate),
    }


def average_metrics(rows: list) -> dict:
    """Mean per metric over per-pair dicts, skipping None / NaN entries."""
    sums, counts = {}, {}
    for row in rows:
        for k, v in row.items():
            if v is None or (isinstance(v, float) and np.isnan(v)):
                continue
            sums[k] = sums.get(k, 0.0) + float(v)
            counts[k] = counts.get(k, 0) + 1
    return {k: sums[k] / counts[k] for k in sums}
