"""1-D convolutions on channels-last (B, T, C) activations.

Counterpart of ``simwhisper_codec_tpu/ops/conv.py``.  Weights are kept in
torch's own layout (``Conv1d``: (O, I/groups, W); ``ConvTranspose1d``:
(I, O/groups, W), un-flipped), so the convs run as native NCW ops with a
transpose at each boundary.  Weights and biases are cast to the activation
dtype, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F


def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


def conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    dilation: int = 1,
    padding: int = 0,
    groups: int = 1,
) -> torch.Tensor:
    """``torch.nn.Conv1d`` semantics on x (B, T, C_in) -> (B, T_out, C_out)."""
    y = F.conv1d(x.transpose(1, 2), w.to(x.dtype), _cast(b, x.dtype), stride=stride,
                 padding=padding, dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def conv_transpose1d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding: int = 0,
    groups: int = 1,
) -> torch.Tensor:
    """``torch.nn.ConvTranspose1d`` semantics (output_padding 0) on (B, T, C_in);
    output length (T - 1) * stride + W - 2 * padding."""
    y = F.conv_transpose1d(x.transpose(1, 2), w.to(x.dtype), _cast(b, x.dtype),
                           stride=stride, padding=padding, groups=groups)
    return y.transpose(1, 2)


def depthwise_conv1d_shifts(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    dilation: int = 1,
    padding: int = 0,
) -> torch.Tensor:
    """Depthwise conv as K shifted multiply-adds, summed in the JAX package's
    order.  x: (B, T, C), w: (K, C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, padding, padding))
    t_out = x.shape[1] + 2 * padding - dilation * (k - 1)
    w = w.to(x.dtype)
    y = None
    for i in range(k):
        term = xp[:, i * dilation: i * dilation + t_out, :] * w[i]
        y = term if y is None else y + term
    if b is not None:
        y = y + b.to(y.dtype)
    return y
