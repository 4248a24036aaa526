"""Symmetric per-output-channel int8 weights for the int8 serving modes.

Counterpart of ``simwhisper_codec_tpu/ops/quant.py:27-72``.  Weights are
quantised once (scale = max|w| / 127 over the input axis, 1 for an all-zero
channel, round half to even); activations are quantised per row inside the
fused int8 kernel.  Weights here are in ``nn.Linear`` layout (out, in), so
the reduction runs over the last axis; the int8 values and scales equal the
JAX package's for the same weights.

The quantised copies are registered on the owning module as non-persistent
buffers (``fc1_q``/``fc1_s``/... and ``pw1_q``/``pw1_s``/...), so they never
enter the state dict.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) f32 -> (int8 (out, in), f32 scales (out,))."""
    s = w.abs().amax(dim=-1, keepdim=True) / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s).to(torch.float32)
    wq = torch.round(w / s).to(torch.int8)
    return wq, s.squeeze(-1)


def _quantize_pair(module, first: str, second: str, tags: Tuple[str, str]) -> None:
    if hasattr(module, f"{tags[0]}_q"):
        return  # idempotent
    if getattr(module, "model_group", None) is not None:
        # a slice of fc2 / pwconv2 would give per-channel scales over that slice only
        raise ValueError("quantise the whole model before parallel.mesh.shard_model, not a shard")
    for lin, tag in ((getattr(module, first), tags[0]), (getattr(module, second), tags[1])):
        q, s = quantize_weight(lin.weight.detach().to(torch.float32))
        module.register_buffer(f"{tag}_q", q, persistent=False)
        module.register_buffer(f"{tag}_s", s, persistent=False)


def quantize_stacked_ffn(layers: Iterable) -> None:
    """Add int8 ``fc1``/``fc2`` weights and scales to each transformer layer."""
    for layer in layers:
        _quantize_pair(layer, "fc1", "fc2", ("fc1", "fc2"))


def quantize_stacked_convnext(blocks: Iterable) -> None:
    """Add int8 ``pwconv1``/``pwconv2`` weights and scales to each ConvNeXt block."""
    for block in blocks:
        _quantize_pair(block, "pwconv1", "pwconv2", ("pw1", "pw2"))
