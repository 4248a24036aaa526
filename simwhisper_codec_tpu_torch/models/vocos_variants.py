"""Vocos variants: ResNet backbone, IMDCT heads, AdaLayerNorm conditioning.

Counterpart of ``simwhisper_codec_tpu/models/vocos_variants.py`` (reference
``audiocodec/nn/modules.py``: ResBlock1 :1281-1422, VocosResNetBackbone
:1507-1542, IMDCTSymExpHead / IMDCTCosHead :1085-1187, AdaLayerNorm
:1251-1278).  Not on the codec's path (it runs the ConvNeXt backbone and
the ISTFT head).  Channels-last (B, T, C).  Submodules carry the reference's
state-dict names (``embed``, ``resnet.{i}.convs1.{j}``, ``resnet.{i}.gamma.{j}``,
``out``, ``scale`` / ``shift``) with plain weights, so
``utils/checkpoint.py::load_reference_checkpoint`` folds the reference's
weight norm into them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from simwhisper_codec_tpu_torch.models.hifigan import lrelu
from simwhisper_codec_tpu_torch.models.transformer import linear
from simwhisper_codec_tpu_torch.ops.conv import conv1d
from simwhisper_codec_tpu_torch.ops.stft import MDCTConstants, imdct


def symexp(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * (exp(|x|) - 1)."""
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


class AdaLayerNorm(nn.Module):
    """LayerNorm without affine, then a per-class scale and shift."""

    def __init__(self, num_embeddings: int, embedding_dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Embedding(num_embeddings, embedding_dim)
        self.shift = nn.Embedding(num_embeddings, embedding_dim)
        nn.init.ones_(self.scale.weight)
        nn.init.zeros_(self.shift.weight)

    def forward(self, x: torch.Tensor, cond_id: torch.Tensor) -> torch.Tensor:
        """x (B, T, D); ``cond_id`` a scalar or (B,) integer tensor."""
        xf = x.to(torch.float32)
        mean = xf.mean(-1, keepdim=True)
        var = torch.square(xf - mean).mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        scale = self.scale.weight[cond_id].to(torch.float32)
        shift = self.shift.weight[cond_id].to(torch.float32)
        if scale.dim() == 2:  # one class a sample: (B, D) -> (B, 1, D)
            scale, shift = scale[:, None], shift[:, None]
        return (y * scale + shift).to(x.dtype)


class ResBlock1(nn.Module):
    """HiFi-GAN ResBlock1 without upsampling: per dilation, leaky ReLU 0.1 ->
    dilated conv -> leaky ReLU -> conv, times an optional per-channel gamma
    (shape (C, 1), as the reference stores it), added to the input."""

    def __init__(self, dim: int, kernel_size: int = 3, dilation: Sequence[int] = (1, 3, 5),
                 lrelu_slope: float = 0.1, layer_scale_init_value: Optional[float] = None):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = tuple(dilation)
        self.slope = lrelu_slope
        self.convs1 = nn.ModuleList(nn.Conv1d(dim, dim, kernel_size, dilation=d) for d in self.dilation)
        self.convs2 = nn.ModuleList(nn.Conv1d(dim, dim, kernel_size) for _ in self.dilation)
        self.gamma = None if layer_scale_init_value is None else nn.ParameterList(
            nn.Parameter(torch.full((dim, 1), float(layer_scale_init_value))) for _ in self.dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        for i, (c1, c2, d) in enumerate(zip(self.convs1, self.convs2, self.dilation)):
            xt = conv1d(lrelu(x, self.slope), c1.weight, c1.bias, dilation=d, padding=(k * d - d) // 2)
            xt = conv1d(lrelu(xt, self.slope), c2.weight, c2.bias, padding=(k - 1) // 2)
            if self.gamma is not None:
                xt = self.gamma[i].reshape(-1).to(xt.dtype) * xt
            x = x + xt
        return x


class VocosResNetBackbone(nn.Module):
    """Embedding conv k3, then ``num_blocks`` ResBlock1s with layer scale
    ``1 / num_blocks / 3`` unless given.  x (B, T, input_channels) -> (B, T, dim)."""

    def __init__(self, input_channels: int, dim: int, num_blocks: int,
                 layer_scale_init_value: Optional[float] = None):
        super().__init__()
        scale = layer_scale_init_value or 1 / num_blocks / 3
        self.embed = nn.Conv1d(input_channels, dim, 3)
        self.resnet = nn.ModuleList(ResBlock1(dim, layer_scale_init_value=scale) for _ in range(num_blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv1d(x, self.embed.weight, self.embed.bias, padding=1)
        for block in self.resnet:
            h = block(h)
        return h


class _IMDCTHead(nn.Module):
    def __init__(self, dim: int, out_dim: int, mdct_frame_len: int, padding: str, clip_audio: bool):
        super().__init__()
        self.out = nn.Linear(dim, out_dim)
        self.imdct = MDCTConstants(mdct_frame_len, padding)
        self.clip_audio = clip_audio

    def _synthesise(self, coeffs: torch.Tensor) -> torch.Tensor:
        """(B, L, N) coefficients -> (B, L * N) audio ("same" padding)."""
        audio = imdct(self.imdct, coeffs.to(torch.float32))
        return torch.clamp(audio, -1.0, 1.0) if self.clip_audio else audio


class IMDCTSymExpHead(_IMDCTHead):
    """Linear -> symexp -> clip to +-1e2 -> IMDCT.  x (B, L, dim) -> (B, L * N)
    with N = mdct_frame_len // 2 ("same" padding)."""

    def __init__(self, dim: int, mdct_frame_len: int, padding: str = "same", clip_audio: bool = False):
        super().__init__(dim, mdct_frame_len // 2, mdct_frame_len, padding, clip_audio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._synthesise(torch.clamp(symexp(linear(x, self.out)), -1e2, 1e2))


class IMDCTCosHead(_IMDCTHead):
    """Linear -> (m, p) -> min(exp(m), 1e2) * cos(p) -> IMDCT."""

    def __init__(self, dim: int, mdct_frame_len: int, padding: str = "same", clip_audio: bool = False):
        super().__init__(dim, mdct_frame_len, mdct_frame_len, padding, clip_audio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m, p = linear(x, self.out).chunk(2, dim=-1)
        return self._synthesise(torch.clamp(torch.exp(m), max=1e2) * torch.cos(p))
