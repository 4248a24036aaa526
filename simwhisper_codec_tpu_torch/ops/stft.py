"""Same-padded ISTFT of the Vocos head, with a virtual right edge.

Counterpart of ``simwhisper_codec_tpu/ops/stft.py:30-115`` (reference
``audiocodec/nn/modules.py:831-886``).  The inverse rDFT is a matmul against
a windowed basis; overlap-add is r = n_fft / hop shifted pads and adds.  The
window envelope is overlap-added from the frame-validity mask, so frames at
or beyond ``frame_valid`` behave as if the array ended there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


class ISTFTConstants(nn.Module):
    """Windowed inverse-rDFT bases and the squared window, as non-persistent buffers."""

    def __init__(self, n_fft: int, hop: int):
        super().__init__()
        assert n_fft % hop == 0, "overlap-add by shifted adds needs hop | n_fft"
        n_freq = n_fft // 2 + 1
        n = np.arange(n_fft, dtype=np.float64)
        window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))  # periodic Hann
        phase = 2.0 * np.pi * np.outer(np.arange(n_freq, dtype=np.float64), n) / n_fft
        coef = np.full((n_freq, 1), 2.0)
        coef[0, 0] = 1.0
        if n_fft % 2 == 0:
            coef[-1, 0] = 1.0
        basis_re = (coef * np.cos(phase) / n_fft) * window[None, :]
        basis_im = (-coef * np.sin(phase) / n_fft) * window[None, :]
        self.register_buffer("basis_re", torch.from_numpy(basis_re.astype(np.float32)), persistent=False)
        self.register_buffer("basis_im", torch.from_numpy(basis_im.astype(np.float32)), persistent=False)
        self.register_buffer("window_sq", torch.from_numpy((window * window).astype(np.float32)),
                             persistent=False)
        self.n_fft = n_fft
        self.hop = hop
        self.pad = (n_fft - hop) // 2


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(..., T, n_fft) -> (..., (T + r - 1) * hop); frame t's j-th block lands in block t + j."""
    *lead, t, n_fft = frames.shape
    r = n_fft // hop
    parts = frames.reshape(*lead, t, r, hop)
    out = None
    for j in range(r):
        shifted = F.pad(parts[..., j, :], (0, 0, j, r - 1 - j))
        out = shifted if out is None else out + shifted
    return out.reshape(*lead, (t + r - 1) * hop)


def istft_same(
    consts: ISTFTConstants,
    spec_re: torch.Tensor,
    spec_im: torch.Tensor,
    frame_valid: Optional[int] = None,
) -> torch.Tensor:
    """spec (B, T, n_freq) f32 -> waveform (B, T * hop).

    With ``frame_valid`` only the first ``frame_valid * hop`` samples are
    meaningful; beyond it the envelope is 0 and the NOLA guard divides by 1.
    """
    t = spec_re.shape[1]
    frames = spec_re @ consts.basis_re + spec_im @ consts.basis_im  # (B, T, n_fft)
    if frame_valid is not None:
        fmask = (torch.arange(t, device=frames.device) < frame_valid).to(frames.dtype)
        frames = frames * fmask[None, :, None]
        wsq_frames = consts.window_sq[None, :] * fmask[:, None]
    else:
        wsq_frames = consts.window_sq[None, :].expand(t, consts.n_fft)
    y = _overlap_add(frames, consts.hop)
    envelope = _overlap_add(wsq_frames, consts.hop)
    envelope = torch.where(envelope > 1e-11, envelope, torch.ones_like(envelope))  # NOLA guard
    y = y / envelope
    return y[:, consts.pad: y.shape[1] - consts.pad]
