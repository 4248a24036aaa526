"""Vocos vocoder: ConvNeXt backbone + ISTFT head.

Counterpart of ``simwhisper_codec_tpu/models/vocos.py`` (reference
``audiocodec/nn/modules.py:1033-1574``).  Submodules follow the reference
keys (``backbone.embed``, ``backbone.convnext.{i}.pwconv1``, ``head.out``).

``frame_valid`` (None, an int, or a 0-d integer tensor on the device, as
the JAX package traces it) is a virtual right edge: inputs are re-zeroed
beyond it before every conv, and the ISTFT envelope ends there, so a fixed
T-frame run reproduces the reference's shorter-array output.  Nothing
reads the tensor on the host, so one captured graph serves every width.

Block impls: ``None`` (exact GELU, parity mode), ``"fused"`` (plain
depthwise conv, then ``csrc/ln_ffn.cu``), ``"fused-dw"`` (the whole block,
depthwise conv and edge mask included, in ``csrc/convnext_dw.cu``) and
``"int8"`` (plain depthwise conv, then ``csrc/ln_ffn_int8.cu``; needs
``ops.quant.quantize_stacked_convnext``).  The residual of a block is its
*unmasked* input, as in the JAX package.

Under tensor parallelism (``parallel/mesh.py::shard_model``) a block holds
its slice of the intermediate width and a ``model_group``; every impl
reduces the ``pwconv2`` partial sums over that group.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from simwhisper_codec_tpu_torch.config import VocosConfig
from simwhisper_codec_tpu_torch.models.sampling import trunc_normal_
from simwhisper_codec_tpu_torch.models.transformer import layer_norm, linear
from simwhisper_codec_tpu_torch.ops.conv import conv1d, depthwise_conv1d_shifts
from simwhisper_codec_tpu_torch.ops.stft import ISTFTConstants, istft_same
from simwhisper_codec_tpu_torch.parallel.mesh import copy_to_model, row_parallel

VOCOS_IMPLS = (None, "fused", "fused-dw", "int8")


def edge_mask(t: int, frame_valid, dtype, device) -> Optional[torch.Tensor]:
    if frame_valid is None:
        return None
    return (torch.arange(t, device=device) < frame_valid).to(dtype)[None, :, None]


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, intermediate: int, layer_scale: float):
        super().__init__()
        self.model_group = None
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate)
        self.pwconv2 = nn.Linear(intermediate, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], impl=None,
                frame_valid=None) -> torch.Tensor:
        """``mask`` is ``edge_mask`` of ``frame_valid``; ``fused-dw`` reads the bound itself."""
        group = self.model_group
        if impl == "fused-dw":
            from simwhisper_codec_tpu_torch.ops.fused_convnext import fused_convnext_block_dw

            return fused_convnext_block_dw(x, self, frame_valid, eps=1e-6, group=group)
        residual = x
        if mask is not None:
            x = x * mask
        x = depthwise_conv1d_shifts(x, self.dwconv.weight[:, 0, :].t(), self.dwconv.bias, padding=3)
        b, t, c = x.shape
        xf, rf = x.reshape(b * t, c), residual.reshape(b * t, c)
        if impl == "int8":
            from simwhisper_codec_tpu_torch.ops.fused_convnext import fused_ln_ffn_int8

            return fused_ln_ffn_int8(xf, rf, self.norm.weight, self.norm.bias, self.pw1_q, self.pw1_s,
                                     self.pwconv1.bias, self.pw2_q, self.pw2_s, self.pwconv2.bias,
                                     self.gamma, eps=1e-6, group=group).reshape(b, t, c)
        if impl == "fused":
            from simwhisper_codec_tpu_torch.ops.fused_convnext import fused_convnext_ffn

            return fused_convnext_ffn(xf, rf, self, group=group).reshape(b, t, c)
        if impl is not None:
            raise ValueError(f"vocos impl must be one of {VOCOS_IMPLS}, got {impl!r}")
        h = copy_to_model(layer_norm(xf, self.norm, eps=1e-6), group)
        h = F.gelu(linear(h, self.pwconv1), approximate="none")
        h = linear(h, self.pwconv2) if group is None else row_parallel(h, self.pwconv2, group)
        return residual + (self.gamma.to(h.dtype) * h).reshape(b, t, c)


class Backbone(nn.Module):
    def __init__(self, cfg: VocosConfig):
        super().__init__()
        self.embed = nn.Conv1d(cfg.input_channels, cfg.dim, 7, padding=3)
        self.norm = nn.LayerNorm(cfg.dim, eps=1e-6)
        self.convnext = nn.ModuleList(ConvNeXtBlock(cfg.dim, cfg.intermediate_dim, cfg.layer_scale_init_value)
                                      for _ in range(cfg.num_layers))
        self.final_layer_norm = nn.LayerNorm(cfg.dim, eps=1e-6)


class Head(nn.Module):
    def __init__(self, cfg: VocosConfig):
        super().__init__()
        self.out = nn.Linear(cfg.dim, cfg.n_fft + 2)


class Vocos(nn.Module):
    def __init__(self, cfg: VocosConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = Backbone(cfg)
        self.head = Head(cfg)
        self.istft = ISTFTConstants(cfg.n_fft, cfg.hop_size)

    def forward(self, mel: torch.Tensor, lengths: torch.Tensor, frame_valid=None,
                impl=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, input_channels) -> waveform (B, T * hop), lengths * hop."""
        bb = self.backbone
        mask = edge_mask(mel.shape[1], frame_valid, mel.dtype, mel.device)
        x = mel if mask is None else mel * mask
        x = conv1d(x, bb.embed.weight, bb.embed.bias, padding=3)
        x = layer_norm(x, bb.norm, eps=1e-6)
        for block in bb.convnext:
            x = block(x, mask, impl, frame_valid)
        x = layer_norm(x, bb.final_layer_norm, eps=1e-6)
        x = linear(x, self.head.out)
        n_freq = self.cfg.n_fft // 2 + 1
        mag = torch.clamp(torch.exp(x[..., :n_freq]), max=1e2)
        phase = x[..., n_freq:]
        spec_re = (mag * torch.cos(phase)).to(torch.float32)
        spec_im = (mag * torch.sin(phase)).to(torch.float32)
        audio = istft_same(self.istft, spec_re, spec_im, frame_valid)
        return audio.to(mel.dtype), lengths * self.cfg.hop_size


def init_vocos(module: Vocos, gen: torch.Generator) -> None:
    """Truncated-normal(0.02) convs and linears, zero biases, unit LayerNorms,
    gamma = 1 / num_layers (reference modules.py:1487-1490)."""
    for sub in module.modules():
        if isinstance(sub, (nn.Conv1d, nn.Linear)):
            trunc_normal_(sub.weight, gen)
            nn.init.zeros_(sub.bias)
        elif isinstance(sub, nn.LayerNorm):
            nn.init.ones_(sub.weight)
            nn.init.zeros_(sub.bias)
        elif isinstance(sub, ConvNeXtBlock):
            nn.init.constant_(sub.gamma, module.cfg.layer_scale_init_value)
