"""Whisper-style log-mel frontend on the device, always in float32.

Counterpart of ``simwhisper_codec_tpu/ops/mel.py`` (reference
``audiocodec/nn/feature_extractor.py:86-112``): centred reflect-padded
framing, the 400-point rDFT as two matmuls against windowed cos/sin bases,
the slaney filterbank, log10 with the per-sample ``max - 8`` floor and the
``(x + 4) / 4`` normalisation.  The last STFT frame is dropped, as in the
reference.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from simwhisper_codec_tpu_torch.config import FeatureExtractorConfig


def hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale (linear below 1 kHz, log above)."""
    freq = np.asarray(freq, dtype=np.float64)
    mels = 3.0 * freq / 200.0
    logstep = 27.0 / np.log(6.4)
    safe = np.maximum(freq, 1e-12)  # avoid log(0) in the unselected branch
    return np.where(freq >= 1000.0, 15.0 + np.log(safe / 1000.0) * logstep, mels)


def mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    freq = 200.0 * mels / 3.0
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= 15.0, 1000.0 * np.exp(logstep * (mels - 15.0)), freq)


def slaney_mel_filter_bank(
    num_frequency_bins: int,
    num_mel_filters: int,
    min_frequency: float,
    max_frequency: float,
    sampling_rate: int,
) -> np.ndarray:
    """Triangular slaney-scale, slaney-normalised filterbank, (F, M) float64
    (HF ``mel_filter_bank(norm='slaney', mel_scale='slaney')``)."""
    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, num_frequency_bins)
    mel_min = hz_to_mel_slaney(np.array(min_frequency))
    mel_max = hz_to_mel_slaney(np.array(max_frequency))
    hz_pts = mel_to_hz_slaney(np.linspace(mel_min, mel_max, num_mel_filters + 2))
    f_diff = np.diff(hz_pts)
    slopes = hz_pts[None, :] - fft_freqs[:, None]  # (F, M+2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    enorm = 2.0 / (hz_pts[2: num_mel_filters + 2] - hz_pts[:num_mel_filters])
    return fb * enorm[None, :]


class MelConstants(nn.Module):
    """DFT bases and filterbank as non-persistent f32 buffers."""

    def __init__(self, cfg: FeatureExtractorConfig):
        super().__init__()
        n_fft, hop = cfg.n_fft, cfg.hop_length
        n_freq = n_fft // 2 + 1
        max_freq = cfg.max_frequency if cfg.max_frequency is not None else cfg.sampling_rate / 2
        fb = slaney_mel_filter_bank(n_freq, cfg.feature_size, 0.0, max_freq, cfg.sampling_rate)
        n = np.arange(n_fft, dtype=np.float64)
        window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))  # periodic Hann
        phase = 2.0 * np.pi * np.outer(n, np.arange(n_freq, dtype=np.float64)) / n_fft
        self.register_buffer("dft_cos", torch.from_numpy((np.cos(phase) * window[:, None]).astype(np.float32)),
                             persistent=False)
        self.register_buffer("dft_sin", torch.from_numpy((-np.sin(phase) * window[:, None]).astype(np.float32)),
                             persistent=False)
        self.register_buffer("mel_fb", torch.from_numpy(fb.astype(np.float32)), persistent=False)
        self.n_fft = n_fft
        self.hop = hop
        self.n_samples = cfg.n_samples
        self.n_frames = cfg.n_samples // hop
        self.n_mels = cfg.feature_size


def reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """``F.pad(x, (left, right), mode="reflect")`` along the last dim, bit for
    bit, built from ``flip`` and ``cat``: their backward is deterministic on
    CUDA, where reflect padding's backward accumulates with atomics (and
    raises under ``torch.use_deterministic_algorithms``)."""
    if max(left, right) >= x.shape[-1]:
        raise ValueError(f"reflect pad ({left}, {right}) needs more samples than {x.shape[-1]}")
    parts = [x]
    if left:
        parts.insert(0, x[..., 1: left + 1].flip(-1))
    if right:
        parts.append(x[..., -right - 1: -1].flip(-1))
    return torch.cat(parts, dim=-1) if len(parts) > 1 else x


def frame_signal(x: torch.Tensor, n_fft: int, hop: int, n_frames: int) -> torch.Tensor:
    """(B, S) -> (B, n_frames, n_fft) centred frames with reflect padding."""
    return reflect_pad(x, n_fft // 2, n_fft // 2).unfold(1, n_fft, hop)[:, :n_frames]


def log_mel(consts: MelConstants, wav: torch.Tensor) -> torch.Tensor:
    """(B, n_samples) waveform -> (B, n_frames, n_mels) normalised log-mel, f32."""
    frames = frame_signal(wav.to(torch.float32), consts.n_fft, consts.hop, consts.n_frames)
    re = frames @ consts.dft_cos
    im = frames @ consts.dft_sin
    mel = (re * re + im * im) @ consts.mel_fb
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    max_val = log_spec.amax(dim=(1, 2), keepdim=True)  # per-sample global max
    log_spec = torch.maximum(log_spec, max_val - 8.0)
    return (log_spec + 4.0) / 4.0


def log_mel_dithered(consts: MelConstants, wav: torch.Tensor, generator: torch.Generator,
                     dither: float) -> torch.Tensor:
    """``log_mel`` of ``wav + dither * noise``, the noise N(0, 1) in ``wav``'s
    dtype drawn from ``generator`` (on ``wav``'s device), as the reference
    dithers (feature_extractor.py:94-95); ``dither = 0`` draws nothing."""
    if dither != 0.0:
        wav = wav + dither * torch.randn(wav.shape, generator=generator, dtype=wav.dtype, device=wav.device)
    return log_mel(consts, wav)


def zero_mean_unit_var_norm(wav: torch.Tensor, lengths: torch.Tensor, padding_value: float = 0.0) -> torch.Tensor:
    """Per-row zero mean and unit variance over the first ``lengths`` samples,
    the rest set to ``padding_value`` (feature_extractor.py:114-134)."""
    mask = (torch.arange(wav.shape[-1], device=wav.device)[None, :] < lengths[:, None]).to(wav.dtype)
    denom = torch.clamp(lengths.to(wav.dtype), min=1.0)[:, None]
    mean = (wav * mask).sum(-1, keepdim=True) / denom
    var = ((wav - mean).square() * mask).sum(-1, keepdim=True) / denom
    normed = (wav - mean) / torch.sqrt(var + 1e-7)
    return torch.where(mask > 0, normed, torch.full_like(normed, padding_value))


def mel_lengths(sample_lengths: torch.Tensor, hop: int, max_frames: int) -> torch.Tensor:
    """Valid mel frames per sample: ceil(len / hop), capped at max_frames."""
    return torch.clamp((sample_lengths + hop - 1) // hop, max=max_frames)
