"""Frame-stack down/up sampling (50 Hz <-> 12.5 Hz) with SnakeBeta residual units.

Counterpart of ``simwhisper_codec_tpu/models/sampling.py`` (reference
``audiocodec/nn/modules.py:37-49, 476-634``).  Channels-last (B, T, C); the
stack keeps the reference's channel order c = d * stack + s_i, so imported
conv weights line up.  The weight-normalised convs of the reference are held
folded (plain ``weight``), as the reference itself runs them at inference.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from simwhisper_codec_tpu_torch.config import SampleStackConfig
from simwhisper_codec_tpu_torch.ops.conv import conv1d
from simwhisper_codec_tpu_torch.ops.snake import AliasFreeConstants, activation1d


class SnakeBeta(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(dim))
        self.beta = nn.Parameter(torch.zeros(dim))


class Activation1d(nn.Module):
    """Holds ``act`` (SnakeBeta) under the reference's key ``block.{0,2}.act``."""

    def __init__(self, dim: int):
        super().__init__()
        self.act = SnakeBeta(dim)

    def forward(self, af: AliasFreeConstants, x: torch.Tensor) -> torch.Tensor:
        return activation1d(af, x, self.act.alpha, self.act.beta)


class ResidualUnit(nn.Module):
    """Snake -> conv k7 (dilated) -> Snake -> conv k1, plus the input."""

    def __init__(self, dim: int, dilation: int):
        super().__init__()
        self.dilation = dilation
        self.block = nn.ModuleList([
            Activation1d(dim), nn.Conv1d(dim, dim, 7, dilation=dilation, padding=3 * dilation),
            Activation1d(dim), nn.Conv1d(dim, dim, 1),
        ])

    def forward(self, af: AliasFreeConstants, x: torch.Tensor) -> torch.Tensor:
        act1, conv1, act2, conv2 = self.block
        h = act1(af, x)
        h = conv1d(h, conv1.weight, conv1.bias, dilation=self.dilation, padding=3 * self.dilation)
        h = act2(af, h)
        return x + conv1d(h, conv2.weight, conv2.bias)


class FrameStackDown(nn.Module):
    """(B, T, in_dim) -> (B, ceil(T / s), latent_dim)  (modules.py:519-550)."""

    def __init__(self, cfg: SampleStackConfig):
        super().__init__()
        self.cfg = cfg
        self.in_proj = nn.Conv1d(cfg.in_dim * cfg.stack_factor, cfg.hidden_dim, 1)
        self.res_blocks = nn.ModuleList(ResidualUnit(cfg.hidden_dim, d) for d in cfg.dilations)
        self.to_latent = nn.Conv1d(cfg.hidden_dim, cfg.latent_dim, 1)

    def forward(self, af, x, lengths) -> Tuple[torch.Tensor, torch.Tensor]:
        s = self.cfg.stack_factor
        b, t, d = x.shape
        out_lengths = (lengths + s - 1) // s
        t_pad = (t + s - 1) // s * s
        x = F.pad(x, (0, 0, 0, t_pad - t))
        # stack: channel c = d * s + s_i  ('b d (t s) -> b (d s) t')
        x = x.reshape(b, t_pad // s, s, d).transpose(2, 3).reshape(b, t_pad // s, d * s)
        h = conv1d(x, self.in_proj.weight, self.in_proj.bias)
        for unit in self.res_blocks:
            h = unit(af, h)
        return conv1d(h, self.to_latent.weight, self.to_latent.bias), out_lengths


class FrameStackUp(nn.Module):
    """(B, T, latent_dim) -> (B, T * s, out_dim)  (modules.py:601-631)."""

    def __init__(self, cfg: SampleStackConfig):
        super().__init__()
        self.cfg = cfg
        self.from_latent = nn.Conv1d(cfg.latent_dim, cfg.hidden_dim, 1)
        self.res_blocks = nn.ModuleList(ResidualUnit(cfg.hidden_dim, d) for d in cfg.dilations)
        self.to_stacked = nn.Conv1d(cfg.hidden_dim, cfg.out_dim * cfg.stack_factor, 1)

    def forward(self, af, z, lengths) -> Tuple[torch.Tensor, torch.Tensor]:
        s = self.cfg.stack_factor
        h = conv1d(z, self.from_latent.weight, self.from_latent.bias)
        for unit in self.res_blocks:
            h = unit(af, h)
        h = conv1d(h, self.to_stacked.weight, self.to_stacked.bias)
        b, t, _ = h.shape
        # unstack: channel c = d * s + s_i -> time t * s + s_i
        y = h.reshape(b, t, self.cfg.out_dim, s).transpose(2, 3).reshape(b, t * s, self.cfg.out_dim)
        return y, lengths * s


def init_sampler(module: nn.Module, gen: torch.Generator) -> None:
    """Truncated-normal(0.02, +-2 sigma) conv weights, zero biases and snake params."""
    for sub in module.modules():
        if isinstance(sub, nn.Conv1d):
            trunc_normal_(sub.weight, gen)
            nn.init.zeros_(sub.bias)
        elif isinstance(sub, SnakeBeta):
            nn.init.zeros_(sub.alpha)
            nn.init.zeros_(sub.beta)


def trunc_normal_(t: torch.Tensor, gen: torch.Generator, std: float = 0.02) -> None:
    nn.init.trunc_normal_(t, mean=0.0, std=std, a=-2 * std, b=2 * std, generator=gen)
