"""Codebook usage diagnostics for the GroupFSQ codec.

A copy of the JAX package's ``eval/codebook.py``: per-group code
histograms, perplexity / entropy and effective bitrate over an encoded
corpus (dead codes, under-used groups).  ``corpus_codebook_stats`` runs the
port's ``AudioCodec.encode``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from simwhisper_codec_tpu_torch.config import QuantizerConfig


class CodebookStats:
    """Accumulates code histograms over (G, T) index arrays."""

    def __init__(self, cfg: QuantizerConfig):
        self.cfg = cfg
        self.size = cfg.codebook_size_per_group
        self.counts = np.zeros((cfg.num_groups, self.size), np.int64)
        self.frames = 0

    def update(self, codes: np.ndarray) -> None:
        """codes: (G, T) int32 for one utterance (or (G, B, T))."""
        codes = np.asarray(codes)
        if codes.ndim == 3:
            codes = codes.reshape(codes.shape[0], -1)
        for g in range(self.cfg.num_groups):
            self.counts[g] += np.bincount(codes[g].reshape(-1), minlength=self.size)
        self.frames += codes.shape[-1]

    def entropy_bits(self) -> np.ndarray:
        """Empirical entropy per group (bits/frame)."""
        p = self.counts / np.maximum(self.counts.sum(axis=1, keepdims=True), 1)
        with np.errstate(divide="ignore", invalid="ignore"):
            h = -np.where(p > 0, p * np.log2(p), 0.0).sum(axis=1)
        return h

    def perplexity(self) -> np.ndarray:
        return 2.0 ** self.entropy_bits()

    def usage(self) -> np.ndarray:
        """Fraction of codebook entries used at least once, per group."""
        return (self.counts > 0).mean(axis=1)

    def report(self, frame_rate_hz: float = 12.5) -> Dict:
        h = self.entropy_bits()
        max_bits = np.log2(self.size)
        return {
            "frames": int(self.frames),
            "entropy_bits_per_group": [round(float(v), 3) for v in h],
            "perplexity_per_group": [round(float(v), 1) for v in self.perplexity()],
            "usage_per_group": [round(float(v), 4) for v in self.usage()],
            "effective_bitrate_bps": round(float(h.sum() * frame_rate_hz), 1),
            "max_bitrate_bps": round(float(max_bits * self.cfg.num_groups * frame_rate_hz), 1),
        }


def corpus_codebook_stats(
    codec, paths: Sequence[str], overlap_seconds: int = 10, batch_size: int = 8
) -> Dict:
    """Encode a corpus and report codebook statistics."""
    from simwhisper_codec_tpu_torch.utils.audio_io import load_audio

    stats = CodebookStats(codec.cfg.quantizer)
    for i in range(0, len(paths), batch_size):
        wavs = [load_audio(p, codec.input_sample_rate) for p in paths[i : i + batch_size]]
        out = codec.encode(wavs, overlap_seconds=overlap_seconds)
        for codes in out["codes_list"]:
            if codes.shape[-1]:
                stats.update(codes)
    return stats.report()
