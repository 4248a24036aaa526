"""SnakeBeta activation inside the alias-free (kaiser-sinc 2x oversampled) wrapper.

Counterpart of ``simwhisper_codec_tpu/ops/snake.py`` (reference
``audiocodec/nn/activations.py:62-120`` and ``alias_free_torch/``).  Both
resamplers are polyphase 6-tap shift-FMA chains over a replicate-padded
signal; the 12 taps are computed in float64 on the host and kept as
non-persistent buffers.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc lowpass taps (alias_free_torch/filter.py:25-54)."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)  # == torch.kaiser_window(periodic=False)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros_like(time, dtype=np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    return (filt / filt.sum()).astype(np.float32)


class AliasFreeConstants(nn.Module):
    """Polyphase taps of the 2x up/down resamplers (ratio 2, 12 taps)."""

    def __init__(self, ratio: int = 2, kernel_size: int = 12):
        super().__init__()
        assert ratio == 2 and kernel_size == 12
        f = kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, kernel_size)
        phases = {
            "up0": 2.0 * f[11::-2],   # f[11], f[9], ..., f[1]
            "up1": 2.0 * f[10::-2],   # f[10], f[8], ..., f[0]
            "down_even": f[0::2],
            "down_odd": f[1::2],
        }
        for name, taps in phases.items():
            self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(taps, np.float32)),
                                 persistent=False)


def _edge_pad(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Replicate-pad (B, T, C) along T."""
    return torch.cat([x[:, :1].expand(-1, lo, -1), x, x[:, -1:].expand(-1, hi, -1)], dim=1)


def shared_filter_shifts(x: torch.Tensor, taps: torch.Tensor, t_out: int, offset: int = 0) -> torch.Tensor:
    """sum_i taps[i] * x[:, offset + i : offset + i + t_out] over a pre-padded x."""
    taps = taps.to(x.dtype)
    y = None
    for i in range(taps.shape[0]):
        term = x[:, offset + i: offset + i + t_out] * taps[i]
        y = term if y is None else y + term
    return y


def snake_beta(x: torch.Tensor, alpha_log: torch.Tensor, beta_log: torch.Tensor) -> torch.Tensor:
    """x + 1/(exp(beta) + 1e-9) * sin(x * exp(alpha))^2, per channel (log-scale params)."""
    alpha = torch.exp(alpha_log.to(x.dtype))
    beta = torch.exp(beta_log.to(x.dtype))
    s = torch.sin(x * alpha)
    return x + (1.0 / (beta + 1e-9)) * (s * s)


def upsample2x(af: AliasFreeConstants, x: torch.Tensor) -> torch.Tensor:
    """Anti-aliased 2x upsample, (B, T, C) -> (B, 2T, C): two interleaved phases."""
    b, t, c = x.shape
    xp = _edge_pad(x, 5, 5)
    y0 = shared_filter_shifts(xp, af.up0, t, offset=2)
    y1 = shared_filter_shifts(xp, af.up1, t, offset=3)
    return torch.stack([y0, y1], dim=2).reshape(b, 2 * t, c)


def downsample2x(af: AliasFreeConstants, x: torch.Tensor) -> torch.Tensor:
    """Anti-aliased 2x downsample, (B, 2T, C) -> (B, T, C): even + odd input phases."""
    t = x.shape[1] // 2
    xp = _edge_pad(x, 5, 6)
    ye = shared_filter_shifts(xp[:, 0::2], af.down_even, t)
    yo = shared_filter_shifts(xp[:, 1::2], af.down_odd, t)
    return ye + yo


def activation1d(af: AliasFreeConstants, x: torch.Tensor, alpha_log: torch.Tensor,
                 beta_log: torch.Tensor) -> torch.Tensor:
    """Alias-free SnakeBeta: up 2x -> snake -> down 2x."""
    return downsample2x(af, snake_beta(upsample2x(af, x), alpha_log, beta_log))
