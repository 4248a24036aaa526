"""Same-padded ISTFT of the Vocos head, with a virtual right edge; the
forward STFT and the MDCT / IMDCT of the variant heads.

Counterpart of ``simwhisper_codec_tpu/ops/stft.py`` (reference
``audiocodec/nn/modules.py:759-1015``).  The inverse rDFT is a matmul against
a windowed basis; overlap-add is r = n_fft / hop shifted pads and adds.  The
window envelope is overlap-added from the frame-validity mask, so frames at
or beyond ``frame_valid`` behave as if the array ended there.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from simwhisper_codec_tpu_torch.ops.mel import reflect_pad


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
    frame_valid=None,
) -> torch.Tensor:
    """spec (B, T, n_freq) f32 -> waveform (B, T * hop).

    With ``frame_valid`` (an int or a 0-d tensor on the device) only the
    first ``frame_valid * hop`` samples are meaningful; beyond it the
    envelope is 0 and the NOLA guard divides by 1.
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


# -- forward STFT (log-magnitude / phase) and MDCT / IMDCT --------------------
# Counterpart of ``simwhisper_codec_tpu/ops/stft.py:125-256`` (reference
# ``modules.py:759-800, 889-1015``): the variant heads' signal ops.


class STFTConstants(nn.Module):
    """Windowed forward-DFT bases (n_fft, n_freq), Hann zero-padded to n_fft
    when ``win_length < n_fft``, as non-persistent buffers."""

    def __init__(self, n_fft: int, hop: int, win_length: int, center: bool = True):
        super().__init__()
        n_freq = n_fft // 2 + 1
        n = np.arange(win_length, dtype=np.float64)
        window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
        if win_length < n_fft:
            lpad = (n_fft - win_length) // 2
            window = np.pad(window, (lpad, n_fft - win_length - lpad))
        phase = 2.0 * np.pi * np.outer(np.arange(n_fft, dtype=np.float64), np.arange(n_freq, dtype=np.float64)) / n_fft
        self.register_buffer("basis_re", torch.from_numpy((np.cos(phase) * window[:, None]).astype(np.float32)),
                             persistent=False)
        self.register_buffer("basis_im", torch.from_numpy((-np.sin(phase) * window[:, None]).astype(np.float32)),
                             persistent=False)
        self.n_fft = n_fft
        self.hop = hop
        self.win_length = win_length
        self.center = center


def make_stft_constants(n_fft: int, hop: int, win_length: int, center: bool = True) -> STFTConstants:
    return STFTConstants(n_fft, hop, win_length, center)


def stft_log_mag_phase(consts: STFTConstants, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S) -> (log(|STFT| + 1e-5), phase), each (B, T, n_freq).

    ``center``: reflect pad n_fft // 2 each side; otherwise reflect pad
    (win - hop) // 2 each side and frame the padded signal as it is."""
    pad = consts.n_fft // 2 if consts.center else (consts.win_length - consts.hop) // 2
    xp = reflect_pad(x, pad, pad)
    n_frames = (xp.shape[1] - consts.n_fft) // consts.hop + 1
    frames = xp.unfold(1, consts.n_fft, consts.hop)[:, :n_frames]
    re = frames @ consts.basis_re
    im = frames @ consts.basis_im
    mag = torch.sqrt(re * re + im * im)
    return torch.log(torch.abs(mag) + 1e-5), torch.atan2(im, re)


class MDCTConstants(nn.Module):
    """Cosine window (``scipy.signal.windows.cosine``) and the complex64 twiddles
    of the MDCT / IMDCT, built in float64 and cast as the JAX package casts them."""

    def __init__(self, frame_len: int, padding: str = "same"):
        super().__init__()
        if padding not in ("center", "same"):
            raise ValueError("Padding must be 'center' or 'same'.")
        n_half = frame_len // 2
        n0 = (n_half + 1) / 2
        window = np.sin(np.pi / frame_len * (np.arange(0, frame_len) + 0.5))
        twiddles = {
            "pre_twiddle": np.exp(-1j * np.pi * np.arange(frame_len) / frame_len),
            "post_twiddle": np.exp(-1j * np.pi * n0 * (np.arange(n_half) + 0.5) / n_half),
            "ipre_twiddle": np.exp(1j * np.pi * n0 * np.arange(2 * n_half) / n_half),
            "ipost_twiddle": np.exp(1j * np.pi * (np.arange(2 * n_half) + n0) / (2 * n_half)),
        }
        self.register_buffer("window", torch.from_numpy(window.astype(np.float32)), persistent=False)
        for name, tw in twiddles.items():
            self.register_buffer(name, torch.from_numpy(tw.astype(np.complex64)), persistent=False)
        self.frame_len = frame_len
        self.padding = padding

    @property
    def pad(self) -> int:
        return self.frame_len // 2 if self.padding == "center" else self.frame_len // 4


def make_mdct_constants(frame_len: int, padding: str = "same") -> MDCTConstants:
    return MDCTConstants(frame_len, padding)


def mdct(consts: MDCTConstants, audio: torch.Tensor) -> torch.Tensor:
    """audio (B, S) -> coefficients (B, L, frame_len // 2), zero padded."""
    n = consts.frame_len // 2
    x = F.pad(audio, (consts.pad, consts.pad)).unfold(1, consts.frame_len, n) * consts.window
    spec = torch.fft.fft(x.to(torch.complex64) * consts.pre_twiddle, dim=-1)[..., :n]
    return (spec * consts.post_twiddle * math.sqrt(1 / n)).real * math.sqrt(2)


def imdct(consts: MDCTConstants, coeffs: torch.Tensor) -> torch.Tensor:
    """coefficients (B, L, N) -> audio (B, (L - 1) * N) after trimming the padding."""
    n = coeffs.shape[-1]
    xc = coeffs.to(torch.complex64)
    spec = torch.cat([xc, -torch.conj(torch.flip(xc, dims=(-1,)))], dim=-1)
    y = torch.fft.ifft(spec * consts.ipre_twiddle, dim=-1)
    y = (y * consts.ipost_twiddle).real * math.sqrt(n) * math.sqrt(2)
    audio = _overlap_add(y * consts.window, n)
    return audio[:, consts.pad: audio.shape[1] - consts.pad]
