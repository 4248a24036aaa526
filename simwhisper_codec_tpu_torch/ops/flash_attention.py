"""Attention core on packed (B, T, 3D) QKV: the CUDA kernel and its plain version.

Counterpart of ``simwhisper_codec_tpu/ops/flash_attention.py:162-263``
(``fused_qkv_attention`` / ``varlen_attention_pflash``).  The kernel is
``csrc/pflash.cu``; see its header for the design.  ``fused_qkv_attention``
launches it for a CUDA tensor and runs ``fused_qkv_attention_plain`` for a
CPU tensor; there is no fallback between the two.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from simwhisper_codec_tpu_torch.ops import _cuda

NEG_BIG = float(np.finfo(np.float32).min)
KERNEL_NAME = "pflash_attention"
HEAD_DIMS = (16, 32, 64, 128)


def fused_qkv_attention_plain(qkv: torch.Tensor, lengths: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The kernel's function step by step: (B, T, 3D) -> (B, T, D).

    Keys >= length get the finite f32 minimum; a length-0 row therefore
    averages all T values uniformly.  Weights are rounded to the input dtype
    before the value product and summed after that rounding; 1/sum is applied
    to the f32 output.
    """
    b, t, d3 = qkv.shape
    d = d3 // 3
    hd = d // num_heads

    def heads(x):
        return x.reshape(b, t, num_heads, hd).transpose(1, 2).to(torch.float32)

    q, k, v = heads(qkv[..., :d]), heads(qkv[..., d:2 * d]), heads(qkv[..., 2 * d:])
    scores = q @ k.transpose(-1, -2)  # (B, H, T, T) f32
    valid = torch.arange(t, device=qkv.device)[None, :] < lengths.to(qkv.device)[:, None]
    scores = torch.where(valid[:, None, None, :], scores, torch.full_like(scores, NEG_BIG))
    m = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - m).to(qkv.dtype).to(torch.float32)
    s = e.sum(-1, keepdim=True)
    o = (e @ v) * (1.0 / s)
    return o.to(qkv.dtype).transpose(1, 2).reshape(b, t, d)


def fused_qkv_attention(qkv: torch.Tensor, lengths: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention core, (B, T, 3D) packed [q | k | v] -> (B, T, D).

    q must be pre-scaled by hd^-1/2 with its bias added; k has no bias.
    CUDA tensors launch ``csrc/pflash.cu`` (bf16 only); CPU tensors run the
    plain version.
    """
    if qkv.device.type == "cpu":
        return fused_qkv_attention_plain(qkv, lengths, num_heads)
    _cuda.require(qkv.device.type == "cuda", f"unsupported device {qkv.device}")
    _cuda.require(qkv.dtype == torch.bfloat16, f"pflash kernel takes bfloat16, got {qkv.dtype}")
    _cuda.require(qkv.dim() == 3 and qkv.is_contiguous(), "qkv must be a contiguous (B, T, 3D) tensor")
    b, t, d3 = qkv.shape
    _cuda.require(d3 % 3 == 0 and (d3 // 3) % num_heads == 0, f"bad packed width {d3} for {num_heads} heads")
    hd = d3 // 3 // num_heads
    _cuda.require(hd in HEAD_DIMS, f"head dim {hd} not in {HEAD_DIMS}")
    _cuda.require(lengths.shape == (b,) and lengths.device == qkv.device, "lengths must be (B,) on the device")
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty((b, t, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    _cuda.launch("pflash", "pflash_bf16", KERNEL_NAME, _cuda.ptr(qkv), _cuda.ptr(lengths), _cuda.ptr(out),
                 *map(_cuda.c_int, (b, t, num_heads, hd)), _cuda.stream(qkv.device))
    return out


def packed_qkv(attn, x: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, T, 3D) = x [s Wq | Wk | Wv]^T + [s bq | 0 | bv], s = hd^-1/2,
    with weights and biases cast to x.dtype as in the JAX wrapper."""
    b, t, d = x.shape
    scale = (d // attn.num_heads) ** -0.5
    w = torch.cat([attn.q_proj.weight * scale, attn.k_proj.weight, attn.v_proj.weight], 0).to(x.dtype)
    bias = torch.cat([attn.q_proj.bias * scale, torch.zeros_like(attn.q_proj.bias), attn.v_proj.bias]).to(x.dtype)
    return (x.reshape(b * t, d) @ w.t()).reshape(b, t, 3 * d) + bias


def varlen_attention_pflash(attn, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Attention sublayer: packed QKV matmul -> attention core -> output projection."""
    b, t, d = x.shape
    o = fused_qkv_attention(packed_qkv(attn, x), lengths, attn.num_heads)
    return F.linear(o.reshape(b * t, d), attn.out_proj.weight.to(x.dtype)).reshape(b, t, d) \
        + attn.out_proj.bias.to(x.dtype)
