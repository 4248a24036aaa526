"""Finite Scalar Quantization (FSQ) and grouped FSQ, vectorised over groups.

Counterpart of ``simwhisper_codec_tpu/ops/fsq.py`` (reference
``audiocodec/nn/quantizer.py:47-318``).  The 8 groups of levels [8, 7, 6, 6]
are one (D,) vector of per-channel constants; the group index is a
base-weighted sum over a (G, d) reshape.  Indices are bit-exact with the JAX
package: both round half to even and round before the int cast.

Layout: latents (B, T, D) channels-last, indices (G, B, T) int32.

The training forward rounds with a straight-through estimator
(``ste_round``: the forward is ``round``, the gradient the identity); the
inference paths round with ``torch.round``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from simwhisper_codec_tpu_torch.config import QuantizerConfig


class FSQConstants(nn.Module):
    """Per-channel constants for the flattened GroupFSQ, as non-persistent buffers."""

    def __init__(self, cfg: QuantizerConfig):
        super().__init__()
        levels = list(cfg.num_levels_per_group)
        base = np.cumprod([1] + levels[:-1]).astype(np.int32)
        lv = np.array(levels, dtype=np.int32)
        scale = ((lv - 1) / 2.0 * (1.0 - cfg.eps)).astype(np.float32)
        offset = np.where(lv % 2 == 0, 0.5, 0.0).astype(np.float32)
        shift = np.tan(offset / scale).astype(np.float32)
        half = (lv // 2).astype(np.float32)
        g = cfg.num_groups
        for name, arr in (("num_levels", lv), ("dim_base", base), ("scale", scale),
                          ("offset", offset), ("shift", shift), ("half_levels", half)):
            self.register_buffer(name, torch.from_numpy(np.tile(arr, g)), persistent=False)
        self.num_groups = g
        self.dims_per_group = len(levels)


def compress(consts: FSQConstants, x: torch.Tensor) -> torch.Tensor:
    """Bounded compression ``scale * tanh(x + shift) - offset``. x: (..., D)."""
    return consts.scale.to(x.dtype) * torch.tanh(x + consts.shift.to(x.dtype)) - consts.offset.to(x.dtype)


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round half to even with a straight-through gradient (reference
    quantizer.py:121-127): ``x + (round(x) - x)`` equals ``round(x)`` exactly
    (|round(x) - x| <= 0.5 is exact in float), and its gradient is 1."""
    return x + (torch.round(x) - x).detach()


def inputs_to_codes(consts: FSQConstants, x: torch.Tensor, ste: bool = False) -> torch.Tensor:
    """Continuous latent -> quantized codes in [-1, 1] (round half to even;
    straight-through gradient with ``ste``)."""
    c = compress(consts, x)
    return (ste_round(c) if ste else torch.round(c)) / consts.half_levels.to(x.dtype)


def codes_to_indices(consts: FSQConstants, codes: torch.Tensor) -> torch.Tensor:
    """Codes (..., D) -> group indices (..., G) int32.

    ``half * code + half`` is an integer in [0, L) in exact arithmetic; an
    FMA can land on N - eps, so it is rounded before the int cast.
    """
    half = consts.half_levels.to(codes.dtype)
    nonneg = torch.round(half * codes + half).to(torch.int32)
    weighted = nonneg * consts.dim_base
    weighted = weighted.reshape(codes.shape[:-1] + (consts.num_groups, consts.dims_per_group))
    return weighted.sum(-1, dtype=torch.int32)


def indices_to_codes(consts: FSQConstants, indices: torch.Tensor) -> torch.Tensor:
    """Group indices (..., G) int32 -> codes (..., D) f32."""
    d = consts.dims_per_group
    idx = indices.to(torch.int32).repeat_interleave(d, dim=-1)
    nonneg = torch.remainder(torch.div(idx, consts.dim_base, rounding_mode="floor"), consts.num_levels)
    return (nonneg.to(torch.float32) - consts.half_levels) / consts.half_levels


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, T) bool validity mask."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def group_fsq_forward(
    consts: FSQConstants, x: torch.Tensor, lengths: Optional[torch.Tensor] = None, ste: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Latent (B, T, D) -> (codes (B, T, D), indices (G, B, T) int32), zero beyond
    lengths; ``ste`` (the training forward) passes the gradient straight through the round."""
    codes = inputs_to_codes(consts, x, ste)
    indices = codes_to_indices(consts, codes)  # (B, T, G)
    if lengths is not None:
        mask = length_mask(lengths, x.shape[1])[..., None]
        codes = codes * mask.to(codes.dtype)
        indices = indices * mask.to(indices.dtype)
    return codes, indices.permute(2, 0, 1).contiguous()


def group_fsq_encode(consts: FSQConstants, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Latent (B, T, D) -> indices (G, B, T) int32, zero beyond lengths (quantizer.py:292-304)."""
    return group_fsq_forward(consts, x, lengths)[1]


def group_fsq_decode(
    consts: FSQConstants, indices: torch.Tensor, lengths: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Indices (G, B, T) int32 -> dequantized latent (B, T, D) f32."""
    codes = indices_to_codes(consts, indices.permute(1, 2, 0))
    if lengths is not None:
        codes = codes * length_mask(lengths, codes.shape[1])[..., None].to(codes.dtype)
    return codes


def codebook_size(cfg: QuantizerConfig) -> int:
    """Distinct code frames: the group codebook size to the number of groups."""
    return cfg.codebook_size_per_group ** cfg.num_groups


def bits_per_frame(cfg: QuantizerConfig) -> float:
    """Bits of one code frame: groups x log2(codebook size); 8 x log2(8*7*6*6)
    = 87.8 for the published config, 1098 bps at 12.5 frames a second."""
    return cfg.num_groups * math.log2(cfg.codebook_size_per_group)
