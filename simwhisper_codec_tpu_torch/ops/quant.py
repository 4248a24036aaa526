"""Symmetric per-output-channel int8 weights for the int8 serving modes,
and the dynamic int8 matmul of ``ffn_impl="int8"``.

Counterpart of ``simwhisper_codec_tpu/ops/quant.py``.  Weights are
quantised once (scale = max|w| / 127 over the input axis, 1 for an all-zero
channel, round half to even); activations are quantised per row inside the
fused int8 kernel, or by ``int8_dynamic_matmul``.  Weights here are in
``nn.Linear`` layout (out, in), so the reduction runs over the last axis;
the int8 values and scales equal the JAX package's for the same weights.

``int8_dynamic_matmul`` is the JAX package's XLA path (no Pallas kernel
there), so it is a library path here too: the s8 x s8 -> s32 product is
cuBLASLt's (``torch._int_mm``) on the card and an exact float64 product on
the CPU.

The quantised copies are registered on the owning module as non-persistent
buffers (``fc1_q``/``fc1_s``/... and ``pw1_q``/``pw1_s``/...), so they never
enter the state dict.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch
import torch.distributed as dist


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) f32 -> (int8 (out, in), f32 scales (out,))."""
    s = w.abs().amax(dim=-1, keepdim=True) / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s).to(torch.float32)
    wq = torch.round(w / s).to(torch.int8)
    return wq, s.squeeze(-1)


def int8_product_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> (M, N) int32, through float64: exact, since
    every partial sum stays below K * 127^2 < 2^53."""
    return (xq.to(torch.float64) @ wq.to(torch.float64).t()).to(torch.int32)


INT_MM_MIN_ROWS = 17  # torch._int_mm takes more than 16 rows


def int8_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> (M, N) int32: ``torch._int_mm`` on CUDA
    tensors (K and N multiples of 8; fewer than 17 rows are padded with
    zero rows and cut off after), the plain version on CPU tensors."""
    if xq.device.type != "cuda":
        return int8_product_plain(xq, wq)
    m, k = xq.shape
    if k % 8 or wq.shape[0] % 8:
        raise ValueError(f"torch._int_mm needs K and N multiples of 8, got K={k}, N={wq.shape[0]}")
    if m < INT_MM_MIN_ROWS:
        xq = torch.cat([xq, xq.new_zeros(INT_MM_MIN_ROWS - m, k)])
    return torch._int_mm(xq.contiguous(), wq.t())[:m]  # wq.t(): the column-major (K, N) cuBLASLt reads


def quantize_rows(x: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, K) bf16 / f32 -> (int8 (M, K), f32 scales (M, 1)): each row by its
    absmax / 127 in f32 (scale 1 for an all-zero row), rounded half to even.
    With a model ``group`` (``parallel/mesh.py``) ``x`` is this rank's slice
    of K and the absmax is the group's (an all-reduce MAX), so each rank
    quantises its slice as the whole row would be."""
    amax = x.abs().amax(dim=-1, keepdim=True).to(torch.float32)
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    xs = amax / 127.0
    xs = torch.where(xs == 0, 1.0, xs)
    return torch.round(x.to(torch.float32) / xs).to(torch.int8), xs


def int8_dynamic_matmul(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, group=None) -> torch.Tensor:
    """(M, K) bf16 / f32 activations x int8 weights (N, K) with scales (N,) ->
    (M, N) f32, as the JAX ``int8_dynamic_matmul``: ``quantize_rows``, the
    s32 product, then ``* row scale * ws``.  With a model ``group``, ``x``
    and ``wq`` hold this rank's slice of K: the rows quantise by the group's
    absmax and the s32 partial products are summed over the group (exact),
    so every rank returns the whole product."""
    xq, xs = quantize_rows(x, group)
    acc = int8_product(xq, wq)
    if group is not None:
        dist.all_reduce(acc, group=group)
    return acc.to(torch.float32) * xs * ws


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
