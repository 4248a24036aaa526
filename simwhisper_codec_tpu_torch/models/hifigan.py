"""HiFi-GAN generator and discriminators (multi-period MPD, multi-scale MSD).

Counterpart of ``simwhisper_codec_tpu/models/hifigan.py`` (the architecture
of SpeechBrain's ``UnitHifiganGenerator`` / ``HifiganDiscriminator`` that the
reference's HiFi-GAN recipes configure, ``hparams/train.yaml:140-228``):

 - Generator (HiFi-GAN V1 on continuous features): conv_pre k7 -> five
   transposed-conv upsamplers (x5, x4, x4, x2, x2 = 320) each followed by the
   mean of three ResBlocks (k 3/7/11, dilations 1/3/5) -> conv_post k7 -> tanh.
 - MPD: periods 2, 3, 5, 7, 11; 2-D convs over (T / p, p).
 - MSD: three scales, average-pooled 4/2 (padding included in the mean)
   between them; the first scale is spectral-normed, the others weight-normed.

Weight norm is the JAX package's own formula, ``g * v / sqrt(sum(v^2) +
1e-12)``, normed over (I, W) per output channel for convs and over (O, W) per
input channel for transposed convs; ``g``, ``v`` and the bias ``b`` are the
trained parameters.  Spectral norm keeps its power-iteration vectors ``u``
and ``v_vec`` as buffers, so no optimizer (and no weight decay) touches them:
15 iterations at init, then ``Discriminator.power_iteration`` once per
training step, before the discriminator forwards; sigma = u^T W v takes its
gradient through W only.

Layouts: the generator takes channels-last features (B, T, C) and returns
(B, T * 320); the discriminators take (B, S) waveforms and run NCW / NCHW
inside, so their feature maps are (B, C, T) and (B, C, T / p, p).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from simwhisper_codec_tpu_torch.ops.mel import reflect_pad


@dataclass(frozen=True)
class HifiGanConfig:
    in_channels: int = 768
    out_channels: int = 1
    upsample_initial_channel: int = 512
    upsample_factors: Tuple[int, ...] = (5, 4, 4, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (11, 8, 8, 4, 4)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    lrelu_slope: float = 0.1

    @property
    def total_upsample(self) -> int:
        out = 1
        for u in self.upsample_factors:
            out *= u
        return out


def lrelu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """Leaky ReLU with the JAX package's ``x >= 0`` branch (gradient 1 at 0)."""
    return torch.where(x >= 0, x, slope * x)


def _wn(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g * v / ||v||, the norm over every dim but the first."""
    return g * v / torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True) + 1e-12)


class WNConv1d(nn.Module):
    """Weight-normed conv: v (O, I / groups, W), g (O, 1, 1), bias b (O,)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1):
        super().__init__()
        self.v = nn.Parameter(torch.zeros(cout, cin // groups, k))
        self.g = nn.Parameter(torch.ones(cout, 1, 1))
        self.b = nn.Parameter(torch.zeros(cout))
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, _wn(self.v, self.g), self.b, self.stride, self.padding, self.dilation, self.groups)


class WNConvTranspose1d(nn.Module):
    """Weight-normed transposed conv: v (I, O, W), g (I, 1, 1) (norm per input channel)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, padding: int):
        super().__init__()
        self.v = nn.Parameter(torch.zeros(cin, cout, k))
        self.g = nn.Parameter(torch.ones(cin, 1, 1))
        self.b = nn.Parameter(torch.zeros(cout))
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, _wn(self.v, self.g), self.b, self.stride, self.padding)


class WNConv2d(nn.Module):
    """Weight-normed 2-D conv with (k, 1) kernels: v (O, I, k, 1), g (O, 1, 1, 1)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, padding: int):
        super().__init__()
        self.v = nn.Parameter(torch.zeros(cout, cin, k, 1))
        self.g = nn.Parameter(torch.ones(cout, 1, 1, 1))
        self.b = nn.Parameter(torch.zeros(cout))
        self.stride, self.padding = (stride, 1), (padding, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, _wn(self.v, self.g), self.b, self.stride, self.padding)


class SNConv1d(nn.Module):
    """Spectral-normed conv (torch ``parametrizations.spectral_norm`` semantics,
    dim 0, eps 1e-12): weight w / sigma, sigma = u^T W v with W = w viewed as
    (O, I / groups * W) and u, v_vec buffers advanced by ``power_iteration``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0, groups: int = 1):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(cout, cin // groups, k))
        self.b = nn.Parameter(torch.zeros(cout))
        self.register_buffer("u", torch.zeros(cout))
        self.register_buffer("v_vec", torch.zeros(cin // groups * k))
        self.stride, self.padding, self.groups = stride, padding, groups

    def weight(self) -> torch.Tensor:
        sigma = self.u @ (self.w.reshape(self.w.shape[0], -1) @ self.v_vec)
        return self.w / sigma

    @torch.no_grad()
    def power_iteration(self, n_iter: int = 1) -> None:
        """u <- normalize(W v); v <- normalize(W^T u), n times (torch's order)."""
        wm = self.w.reshape(self.w.shape[0], -1)
        u, v = self.u, self.v_vec
        for _ in range(n_iter):
            u = F.normalize(wm @ v, dim=0, eps=1e-12)
            v = F.normalize(wm.t() @ u, dim=0, eps=1e-12)
        self.u.copy_(u)
        self.v_vec.copy_(v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.weight(), self.b, self.stride, self.padding, 1, self.groups)


# -- generator ---------------------------------------------------------------


class ResBlock1(nn.Module):
    """HiFi-GAN V1 ResBlock: (lrelu -> dilated conv -> lrelu -> conv) + x, per dilation."""

    def __init__(self, ch: int, k: int, dilations, slope: float):
        super().__init__()
        self.slope = slope
        self.convs1 = nn.ModuleList(WNConv1d(ch, ch, k, padding=(k * d - d) // 2, dilation=d) for d in dilations)
        self.convs2 = nn.ModuleList(WNConv1d(ch, ch, k, padding=(k - 1) // 2) for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(lrelu(c1(lrelu(x, self.slope)), self.slope))
        return x


class Generator(nn.Module):
    def __init__(self, cfg: HifiGanConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.upsample_initial_channel
        self.conv_pre = WNConv1d(cfg.in_channels, ch, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_factors, cfg.upsample_kernel_sizes)):
            cout = ch // 2 ** (i + 1)
            self.ups.append(WNConvTranspose1d(ch // 2 ** i, cout, k, u, (k - u) // 2))
            self.resblocks.append(nn.ModuleList(
                ResBlock1(cout, rk, rd, cfg.lrelu_slope)
                for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)))
        self.conv_post = WNConv1d(ch // 2 ** len(cfg.upsample_factors), cfg.out_channels, 7, padding=3)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        """(B, T, in_channels) features -> (B, T * total_upsample) waveform."""
        slope = self.cfg.lrelu_slope
        x = self.conv_pre(features.transpose(1, 2))
        for up, blocks in zip(self.ups, self.resblocks):
            x = up(lrelu(x, slope))
            acc = None
            for block in blocks:
                out = block(x)
                acc = out if acc is None else acc + out
            x = acc / len(blocks)
        return torch.tanh(self.conv_post(lrelu(x, slope)))[:, 0]


# -- discriminators ----------------------------------------------------------

MPD_PERIODS = (2, 3, 5, 7, 11)
MPD_CHANNELS = (1, 32, 128, 512, 1024, 1024)
# (kernel, stride, groups, out_channels) of each MSD conv before conv_post
MSD_SPEC = ((15, 1, 1, 128), (41, 2, 4, 128), (41, 2, 16, 256), (41, 4, 16, 512),
            (41, 4, 16, 1024), (41, 1, 16, 1024), (5, 1, 1, 1024))
LRELU_SLOPE = 0.1


class PeriodDiscriminator(nn.Module):
    def __init__(self, period: int):
        super().__init__()
        self.period = period
        ch = MPD_CHANNELS
        self.convs = nn.ModuleList(WNConv2d(ch[i], ch[i + 1], 5, 3, 2) for i in range(len(ch) - 1))
        self.conv_post = WNConv2d(ch[-1], 1, 3, 1, 1)

    def forward(self, x: torch.Tensor):
        """(B, T) -> (score (B, n), feature maps (B, C, T / p, p))."""
        b, t = x.shape
        pad = (self.period - t % self.period) % self.period
        if pad:
            x = reflect_pad(x, 0, pad)
        h = x.reshape(b, 1, -1, self.period)
        feats = []
        for conv in self.convs:
            h = lrelu(conv(h), LRELU_SLOPE)
            feats.append(h)
        h = self.conv_post(h)
        feats.append(h)
        return h.reshape(b, -1), feats


class ScaleDiscriminator(nn.Module):
    def __init__(self, spectral_norm: bool = False):
        super().__init__()
        convs, cin = [], 1
        for k, s, g, cout in MSD_SPEC:
            conv = SNConv1d if spectral_norm else WNConv1d
            convs.append(conv(cin, cout, k, stride=s, padding=k // 2, groups=g))
            cin = cout
        self.convs = nn.ModuleList(convs)
        self.conv_post = (SNConv1d if spectral_norm else WNConv1d)(cin, 1, 3, padding=1)

    def forward(self, x: torch.Tensor):
        """(B, T) -> (score (B, T'), feature maps (B, C, T'))."""
        h = x[:, None]
        feats = []
        for conv in self.convs:
            h = lrelu(conv(h), LRELU_SLOPE)
            feats.append(h)
        h = self.conv_post(h)
        feats.append(h)
        return h[:, 0], feats


class Discriminator(nn.Module):
    """HifiganDiscriminator: the MPD over five periods, then the MSD over three scales."""

    def __init__(self):
        super().__init__()
        self.mpd = nn.ModuleList(PeriodDiscriminator(p) for p in MPD_PERIODS)
        self.msd = nn.ModuleList(ScaleDiscriminator(spectral_norm=(i == 0)) for i in range(3))

    def power_iteration(self) -> None:
        """Advance every spectral-normed conv's u / v_vec once (call once per
        training step, before the discriminator forwards)."""
        for m in self.modules():
            if isinstance(m, SNConv1d):
                m.power_iteration()

    def forward(self, x: torch.Tensor) -> Tuple[List[torch.Tensor], List[List[torch.Tensor]]]:
        """(B, T) waveform -> (scores, feature lists), one entry per sub-discriminator."""
        scores, feats = [], []
        for d in self.mpd:
            s, f = d(x)
            scores.append(s)
            feats.append(f)
        h = x
        for i, d in enumerate(self.msd):
            if i > 0:
                h = F.avg_pool1d(h[:, None], 4, 2, padding=2, count_include_pad=True)[:, 0]
            s, f = d(h)
            scores.append(s)
            feats.append(f)
        return scores, feats


# -- initialisation (the JAX package's scheme: N(0, 0.01^2) v, g = ||v||, zero biases)


def init_hifigan(module: nn.Module, generator: Optional[torch.Generator] = None, scale: float = 0.01,
                 n_init_iter: int = 15) -> nn.Module:
    """Randomly initialise a Generator or Discriminator in place: weight-normed
    v ~ N(0, scale^2) with g = ||v|| (so the effective weight is v), zero
    biases; spectral-normed w ~ N(0, scale^2), unit random u / v_vec, then
    ``n_init_iter`` power iterations, as torch's spectral_norm registration."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (WNConv1d, WNConvTranspose1d, WNConv2d)):
                m.v.copy_(torch.randn(m.v.shape, generator=gen) * scale)
                m.g.copy_(torch.sqrt(torch.sum(m.v * m.v, dim=tuple(range(1, m.v.dim())), keepdim=True)))
                m.b.zero_()
            elif isinstance(m, SNConv1d):
                m.w.copy_(torch.randn(m.w.shape, generator=gen) * scale)
                m.b.zero_()
                m.u.copy_(F.normalize(torch.randn(m.u.shape, generator=gen), dim=0, eps=1e-12))
                m.v_vec.copy_(F.normalize(torch.randn(m.v_vec.shape, generator=gen), dim=0, eps=1e-12))
                m.power_iteration(n_init_iter)
    return module
