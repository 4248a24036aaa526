"""Attention cores: CUDA kernels and their plain versions.

Counterpart of ``simwhisper_codec_tpu/ops/flash_attention.py``:

- ``fused_qkv_attention`` / ``varlen_attention_pflash`` (:162-263), on
  packed (B, T, 3D) QKV, normalisation deferred to the output: kernel
  ``csrc/pflash.cu`` (B1) for bf16, ``pflash_f32`` of ``csrc/attn_f32.cu``
  for f32;
- ``flash_attention`` / ``varlen_attention_flash`` (:62-100, :266-288), on
  (B, H, T, hd) q, k, v, weights normalised before the value product:
  kernel ``csrc/flash.cu`` (B5) for bf16, ``flash_attention_f32`` of
  ``csrc/attn_f32.cu`` for f32.

The bf16 kernels are one Hopper design (``csrc/attn_sm90.cuh``): TMA tile
loads into a shared-memory ring, ``wgmma`` for both products.  The f32
kernels (parity mode with ``attn_impl`` ``pflash`` or ``flash``) load their
tiles the same way and compute with f32 FMAs.  The tensor maps of all
operands are encoded in C from the geometry that ``tile_map`` computes
here.  See the kernels' headers for their designs.  Each wrapper launches
its kernel for a CUDA tensor and runs the plain version for a CPU tensor;
there is no fallback between the two.  The sublayer wrappers take the head
count and width from the layer (``num_heads``, ``head_dim``), so under
tensor parallelism the kernels run on a rank's local heads, and the output
projection is then that rank's partial, reduced over its model group.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from simwhisper_codec_tpu_torch.ops import _cuda

NEG_BIG = float(np.finfo(np.float32).min)
KERNEL_NAME = "pflash_attention"
FLASH_KERNEL_NAME = "flash_attention"
# (library, C entry point, launch-count key) of each kernel, by input dtype
PFLASH_KERNELS = {torch.bfloat16: ("pflash", "pflash_bf16", KERNEL_NAME),
                  torch.float32: ("attn_f32", "pflash_f32", KERNEL_NAME + "_f32")}
FLASH_KERNELS = {torch.bfloat16: ("flash", "flash_attention_bf16", FLASH_KERNEL_NAME),
                 torch.float32: ("attn_f32", "flash_attention_f32", FLASH_KERNEL_NAME + "_f32")}
HEAD_DIMS = (16, 32, 64, 128)
TILE_ROWS = 64  # rows (keys, or query rows) of one TMA box: the kernels' key tile
MAX_BOX_BYTES = 128  # the widest swizzle: 64 bf16 or 32 f32 columns; wider heads take several boxes


class TileMap(NamedTuple):
    """TMA geometry of one operand (bf16 or f32) of the attention kernels."""

    dims: Tuple[int, ...]  # elements, innermost first
    strides: Tuple[int, ...]  # bytes, of dims 1, 2, ...
    box: Tuple[int, ...]  # elements of one box, innermost first
    swizzle: int  # bytes (32, 64 or 128): the width of one box row

    def as_c(self) -> ctypes.Array:
        """[rank, dims[5], strides[4], box[5], swizzle] as the C entry points read it."""
        pad = lambda v, k: list(v) + [0] * (k - len(v))
        vals = [len(self.dims), *pad(self.dims, 5), *pad(self.strides, 4), *pad(self.box, 5), self.swizzle]
        return (ctypes.c_longlong * len(vals))(*vals)


def tile_map(x: torch.Tensor, hd: int) -> TileMap:
    """The tensor map of an attention operand, from its shape and strides.

    ``x`` is the packed (B, T, 3D) QKV tensor (a 3-D map (3D, T, B): head h's
    q, k and v are boxes at columns h*hd, D + h*hd and 2D + h*hd) or a
    (B, H, T, hd) view (a 4-D map (hd, T, H, B) by its strides).  A box is
    64 rows of at most 128 bytes (min(hd, 64) bf16 or min(hd, 32) f32
    columns), swizzled by its row width; rows past T read as zeros.
    Raises ValueError where the TMA cannot take the layout:
    a last dim that is not contiguous, a base not 16-byte aligned, a byte
    stride not a multiple of 16.
    """
    _cuda.require(hd in HEAD_DIMS, f"head dim {hd} not in {HEAD_DIMS}")
    _cuda.require(x.dtype in (torch.bfloat16, torch.float32), f"a bf16 or f32 operand, got {x.dtype}")
    _cuda.require(x.dim() in (3, 4) and x.stride(-1) == 1, "the last dim must be contiguous")
    item = x.element_size()
    if x.dim() == 3:
        b, t, width = x.shape
        dims, strides = (width, t, b), (x.stride(1), x.stride(0))
    else:
        b, h, t, d = x.shape
        _cuda.require(d == hd, f"a (B, H, T, hd) view with hd {d}, expected {hd}")
        dims, strides = (hd, t, h, b), (x.stride(2), x.stride(1), x.stride(0))
    byte_strides = tuple(s * item for s in strides)
    _cuda.require(all(s % 16 == 0 and 0 < s < 1 << 40 for s in byte_strides),
                  f"byte strides {byte_strides} must be positive multiples of 16")
    _cuda.require(x.data_ptr() % 16 == 0, "the tensor's base must be 16-byte aligned")
    cols = min(hd, MAX_BOX_BYTES // item)
    box = (cols, TILE_ROWS) + (1,) * (len(dims) - 2)
    return TileMap(dims, byte_strides, box, cols * item)


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
    CUDA tensors launch ``csrc/pflash.cu`` (bf16) or ``pflash_f32`` of
    ``csrc/attn_f32.cu`` (f32); CPU tensors run the plain version.
    """
    if qkv.device.type == "cpu":
        return fused_qkv_attention_plain(qkv, lengths, num_heads)
    _cuda.require(qkv.device.type == "cuda", f"unsupported device {qkv.device}")
    kernel = PFLASH_KERNELS.get(qkv.dtype)
    _cuda.require(kernel is not None, f"pflash kernels take bfloat16 or float32, got {qkv.dtype}")
    _cuda.require(qkv.dim() == 3 and qkv.is_contiguous(), "qkv must be a contiguous (B, T, 3D) tensor")
    b, t, d3 = qkv.shape
    _cuda.require(d3 % 3 == 0 and (d3 // 3) % num_heads == 0, f"bad packed width {d3} for {num_heads} heads")
    hd = d3 // 3 // num_heads
    _cuda.require(hd in HEAD_DIMS, f"head dim {hd} not in {HEAD_DIMS}")
    _cuda.require(lengths.shape == (b,) and lengths.device == qkv.device, "lengths must be (B,) on the device")
    lengths = lengths.to(torch.int32).contiguous()
    geom = tile_map(qkv, hd).as_c()
    out = torch.empty((b, t, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    _cuda.launch(*kernel, _cuda.ptr(qkv), _cuda.ptr(lengths), _cuda.ptr(out),
                 *map(_cuda.c_int, (b, t, num_heads, hd)), geom, _cuda.stream(qkv.device))
    return out


def packed_qkv(attn, x: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, T, 3W) = x [s Wq | Wk | Wv]^T + [s bq | 0 | bv] for the
    layer's H heads of hd (W = H hd, s = hd^-1/2; under tensor parallelism
    H is the rank's share), with weights and biases cast to x.dtype as in the
    JAX wrapper."""
    b, t, d = x.shape
    width = attn.num_heads * attn.head_dim
    scale = attn.head_dim ** -0.5
    w = torch.cat([attn.q_proj.weight * scale, attn.k_proj.weight, attn.v_proj.weight], 0).to(x.dtype)
    bias = torch.cat([attn.q_proj.bias * scale, torch.zeros_like(attn.q_proj.bias), attn.v_proj.bias]).to(x.dtype)
    return (x.reshape(b * t, d) @ w.t()).reshape(b, t, 3 * width) + bias


def varlen_attention_pflash(attn, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Attention sublayer: packed QKV matmul -> attention core -> output projection."""
    return attn.project(fused_qkv_attention(packed_qkv(attn, x), lengths, attn.num_heads), bias_after=True)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The B5 kernel's function step by step: (B, H, T, hd) -> (B, H, T, hd).

    Scores get +1.0 on keys < length and the finite f32 minimum elsewhere
    (a length-0 row therefore averages all T values uniformly); the weights
    are normalised in f32 and only then rounded to the input dtype.
    """
    t = q.shape[2]
    scores = q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)  # (B, H, T, T)
    valid = torch.arange(t, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    bias = torch.where(valid, 1.0, NEG_BIG)
    scores = scores + bias[:, None, None, :]
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(q.dtype).to(torch.float32)
    return (p @ v.to(torch.float32)).to(q.dtype)


def _strides(x: torch.Tensor) -> list:
    """The batch, head and time strides of the (B, H, T, hd) output, which the kernel writes by stride."""
    per16 = 16 // x.element_size()
    _cuda.require(x.stride(-1) == 1 and all(s % per16 == 0 for s in x.stride()[:3]) and x.data_ptr() % 16 == 0,
                  f"out needs a contiguous, 16-byte aligned head dim and strides that are multiples of {per16}")
    return [_cuda.c_int64(s) for s in x.stride()[:3]]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Variable-length attention on (B, H, T, hd) q, k, v -> (B, H, T, hd).

    q must be pre-scaled by hd^-1/2.  The inputs may be strided views (e.g.
    (B, T, H, hd) projections transposed); for a CUDA tensor the output is
    a (B, H, T, hd) view of a contiguous (B, T, H, hd) buffer, so the caller's
    transpose back to (B, T, D) costs no copy.  CUDA tensors launch
    ``csrc/flash.cu`` (bf16) or ``flash_attention_f32`` of
    ``csrc/attn_f32.cu`` (f32); CPU tensors run the plain version.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, lengths)
    _cuda.require(q.device.type == "cuda", f"unsupported device {q.device}")
    _cuda.require(q.dim() == 4 and k.shape == q.shape and v.shape == q.shape,
                  "q, k and v must be (B, H, T, hd) tensors of one shape")
    kernel = FLASH_KERNELS.get(q.dtype)
    _cuda.require(kernel is not None and all(z.dtype == q.dtype and z.device == q.device for z in (k, v)),
                  f"flash kernels take bfloat16 or float32 q, k, v of one dtype on one device, got {q.dtype}")
    b, h, t, hd = q.shape
    _cuda.require(hd in HEAD_DIMS, f"head dim {hd} not in {HEAD_DIMS}")
    _cuda.require(lengths.shape == (b,) and lengths.device == q.device, "lengths must be (B,) on the device")
    lengths = lengths.to(torch.int32).contiguous()
    geoms = [tile_map(z, hd).as_c() for z in (q, k, v)]
    out = torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    _cuda.launch(*kernel, _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v),
                 _cuda.ptr(lengths), _cuda.ptr(out), *map(_cuda.c_int, (b, h, t, hd)), *geoms,
                 *_strides(out), _cuda.stream(q.device))
    return out


def varlen_attention_flash(attn, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Attention sublayer of the B5 path, in the JAX wrapper's order:
    q = (x Wq + bq) hd^-1/2, k = x Wk, v = x Wv + bv (one packed product,
    viewed per head by stride), attention core, output projection."""
    b, t, d = x.shape
    h, hd = attn.num_heads, attn.head_dim
    w = torch.cat([attn.q_proj.weight, attn.k_proj.weight, attn.v_proj.weight], 0).to(x.dtype)
    qkv = (x.reshape(b * t, d) @ w.t()).reshape(b, t, 3, h, hd)
    q = (qkv[:, :, 0] + attn.q_proj.bias.to(x.dtype).reshape(h, hd)) * hd ** -0.5
    k = qkv[:, :, 1]
    v = qkv[:, :, 2] + attn.v_proj.bias.to(x.dtype).reshape(h, hd)
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), lengths)
    return attn.project(attn.merge(o), bias_after=True)
