"""Fused LN -> FFN -> layer scale -> residual chains: CUDA kernels and plain versions.

Counterpart of ``simwhisper_codec_tpu/ops/fused_convnext.py`` (``fused_ln_ffn``
and ``fused_convnext_ffn`` :38-139, ``fused_convnext_block_dw`` :142-258,
``fused_ln_ffn_int8`` :261-357).  The kernels are ``csrc/ln_ffn.cu`` (bf16),
``csrc/convnext_dw.cu`` (the whole ConvNeXt block, depthwise conv included)
and ``csrc/ln_ffn_int8.cu`` (int8); see their headers for the designs.  All
three run as passes (a row kernel, then up- and down-projection GEMMs on
``csrc/ffn_sm90.cuh``; B4's row kernel forms the masked depthwise conv
before the LayerNorm, then runs B2's passes) through workspaces allocated
here, with the TMA geometry of every GEMM operand from ``operand_map``.
Each wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor; there is no fallback between the two.
``fused_convnext_block`` runs a Vocos block's B2 or B3 chain with the
depthwise conv folded into the rows pass (``csrc/dw_rows.cuh``), rounded as
the plain conv rounds, on CUDA tensors only.

All (M, C) rows; weights in ``nn.Linear`` layout: W1 (I, C), W2 (C, I).
As in the JAX wrappers, every operand is cast to x.dtype first (the int8
weight scales stay f32); LN, accumulation and the epilogue are f32; the GELU
is the tanh approximation.

Tensor parallelism (``group``, a model group of ``parallel/mesh.py``): each
rank holds a slice of I, so its down product is a partial sum.  The
partial-mode passes (``ln_ffn_partial``, ``ln_ffn_int8_partial``,
``convnext_dw_partial``) write the f32 ``gamma (h W2^T + b2)`` of the
slice, b2 on the group's first rank only, and no residual; the wrapper
all-reduces them and forms ``bf16(residual + sum)``, rounding once as the
unsharded kernel does.  B3 quantises h by its row maximum over all of I:
its rows and up-max passes run first, the ``hmax`` workspace is
all-reduced (MAX) over the group, then the up-quantise and down passes run.
Without a group every wrapper runs as in one process.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.distributed as dist
from torch.nn import functional as F

from simwhisper_codec_tpu_torch.ops import _cuda
from simwhisper_codec_tpu_torch.ops.flash_attention import TileMap


def _gelu_tanh(h: torch.Tensor) -> torch.Tensor:
    h3 = h * h * h
    return 0.5 * h * (1.0 + torch.tanh(0.7978845608028654 * (h + 0.044715 * h3)))


def _ln_f32(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mean).mean(-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * ln_w.to(torch.float32) + ln_b.to(torch.float32)


def _gamma(gamma: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return torch.ones(x.shape[-1], dtype=x.dtype, device=x.device) if gamma is None else gamma.to(x.dtype)


def _row_quant(v: torch.Tensor, amax: Optional[torch.Tensor] = None):
    """Per-row absmax int8 quantisation of f32 rows -> (integer-valued f32,
    scale); ``amax`` (rows, 1) is the rows' absmax where it is known (over
    all of I when v is one rank's slice)."""
    s = (v.abs().amax(-1, keepdim=True) if amax is None else amax) / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    return torch.round(v / s), s


def _int_matmul(aq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact s8 x s8 product: float64 holds every partial sum exactly
    (127^2 * I < 2^53), float32 would not (2^24 < 127^2 * 4096)."""
    return (aq.to(torch.float64) @ wq.to(torch.float64).t()).to(torch.float32)


def _ln_ffn_y_plain(x, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, dt):
    """The bf16 chain's f32 gamma (h W2^T + b2) on rows x (any float dtype,
    normalised in f32), every operand cast to ``dt`` first; b2 None adds no bias."""
    w1, w2 = w1.to(dt).to(torch.float32), w2.to(dt).to(torch.float32)
    xn = _ln_f32(x, ln_w.to(dt), ln_b.to(dt), eps).to(dt).to(torch.float32)
    h = _gelu_tanh(xn @ w1.t() + b1.to(dt).to(torch.float32)).to(dt).to(torch.float32)
    y = h @ w2.t()
    if b2 is not None:
        y = y + b2.to(dt).to(torch.float32)
    g = torch.ones(w2.shape[0], dtype=dt, device=x.device) if gamma is None else gamma.to(dt)
    return g.to(torch.float32) * y


def _ln_ffn_chain_plain(x, residual, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, dt):
    """The bf16 chain on rows x (any float dtype, normalised in f32), every
    operand cast to ``dt`` first, output in ``dt``."""
    y = _ln_ffn_y_plain(x, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, dt)
    return (residual.to(torch.float32) + y).to(dt)


def fused_ln_ffn_plain(x, residual, ln_w, ln_b, w1, b1, w2, b2, gamma=None, eps=1e-6):
    """res + gamma * (GELU_tanh(LN(x) W1^T + b1) W2^T + b2), step by step."""
    return _ln_ffn_chain_plain(x, residual, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, x.dtype)


def fused_ln_ffn_int8_up_plain(x, ln_w, ln_b, w1q, s1, b1, eps=1e-6):
    """LN -> row quant -> exact s8 product -> rescale -> GELU: the f32 h (M, I)
    of the int8 chain (what B3's up passes form before quantising it; on a
    rank's slice of I under tensor parallelism)."""
    dt = x.dtype
    xq, xs = _row_quant(_ln_f32(x, ln_w.to(dt), ln_b.to(dt), eps))
    return _gelu_tanh(_int_matmul(xq, w1q) * xs * s1.to(torch.float32) + b1.to(dt).to(torch.float32))


def _int8_y_plain(h, w2q, s2, b2, gamma, dt, amax=None):
    """row requant of h (by ``amax`` where given) -> exact s8 product -> rescale
    -> f32 gamma (... + b2); b2 None adds no bias."""
    hq, hs = _row_quant(h, amax)
    y = _int_matmul(hq, w2q) * hs * s2.to(torch.float32)
    if b2 is not None:
        y = y + b2.to(dt).to(torch.float32)
    g = torch.ones(w2q.shape[0], dtype=dt, device=h.device) if gamma is None else gamma.to(dt)
    return g.to(torch.float32) * y


def fused_ln_ffn_int8_plain(x, residual, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, gamma=None, eps=1e-6):
    """int8 chain step by step: LN -> row quant -> exact s8 product -> rescale
    -> GELU -> row requant -> exact s8 product -> rescale -> gamma -> residual."""
    y = _int8_y_plain(fused_ln_ffn_int8_up_plain(x, ln_w, ln_b, w1q, s1, b1, eps), w2q, s2, b2, gamma, x.dtype)
    return (residual.to(torch.float32) + y).to(x.dtype)


def fused_ln_ffn_partial_plain(x, ln_w, ln_b, w1, b1, w2, b2=None, gamma=None, eps=1e-6):
    """Partial mode of the bf16 chain, step by step: the f32
    gamma (GELU_tanh(LN(x) W1^T + b1) W2^T + b2) of this rank's slice of I
    (W1's rows, b1, W2's columns), with b2 on one rank only (None elsewhere)
    and no residual; (M, C) f32."""
    return _ln_ffn_y_plain(x, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, x.dtype)


def fused_ln_ffn_int8_partial_plain(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2=None, gamma=None, eps=1e-6,
                                    reduce_max=None):
    """Partial mode of the int8 chain, step by step: h of this rank's slice,
    its rows' |h| max (M,) f32, which ``reduce_max`` (if given) reduces in
    place through its int32 view (non-negative floats order as their bits),
    then h quantised by that max, the second product and the f32
    gamma (... + b2) with b2 on one rank only; (M, C) f32."""
    h = fused_ln_ffn_int8_up_plain(x, ln_w, ln_b, w1q, s1, b1, eps)
    hmax = h.abs().amax(-1)
    if reduce_max is not None:
        reduce_max(hmax.view(torch.int32))
    return _int8_y_plain(h, w2q, s2, b2, gamma, x.dtype, hmax[:, None])


def _check_rows(x, residual, c_max=768):
    """The rows' checks, on any device (``meta`` plans a call; the launch requires CUDA)."""
    _cuda.require(x.dtype == torch.bfloat16, f"fused LN-FFN kernels take bfloat16, got {x.dtype}")
    _cuda.require(x.dim() == 2 and x.is_contiguous(), "x must be a contiguous (M, C) tensor")
    _cuda.require(residual.shape == x.shape and residual.dtype == x.dtype and residual.is_contiguous()
                  and residual.device == x.device, "residual must match x")
    c = x.shape[1]
    _cuda.require(c % 64 == 0 and 64 <= c <= c_max, f"C={c} must be a multiple of 64 up to {c_max}")


def _vec(t: torch.Tensor, n: int, dtype, device) -> torch.Tensor:
    _cuda.require(t.numel() == n and t.device == device, f"vector of {n} expected on {device}")
    return t.to(dtype).contiguous()


# ---- the passes of B2, B3 and B4 (csrc/ffn_sm90.cuh) ------------------------

ROW_TILE = 128  # rows of a block tile, = rows of an activation operand's TMA box
K_SLICE_BYTES = 128  # one K slice of an operand's box: 64 bf16 or 128 int8, the 128-byte swizzle span
BLOCK_NS = (256, 192, 128)  # the kernels' block widths, widest first
# The up passes' epilogues (tanh-GELU, and for int8 the quantisation) take
# longer than their main loops, so they run 128-wide blocks, two an SM, and
# one block's epilogue overlaps the other's products.
UP_BLOCK_N = 128
H100_SMS = 132
MAX_ROWS = 65535 * ROW_TILE  # row tiles are the grid's y dimension
# bit of each pass in the C entry points' ``passes`` argument; the partial
# modes (tensor parallelism) swap the down pass for the f32 partial one
BF16_PASSES = {"rows": 1, "up": 2, "down": 4}
INT8_PASSES = {"rows": 1, "up_max": 2, "up_quant": 4, "down": 8}
BF16_PARTIAL_PASSES = {"rows": 1, "up": 2, "down_partial": 8}
INT8_PARTIAL_PASSES = {"rows": 1, "up_max": 2, "up_quant": 4, "down_partial": 16}
HMAX_INDEX = 14  # of the hmax workspace among ``_ln_ffn_int8_args``' tensors


def operand_map(x: torch.Tensor, box_rows: int) -> TileMap:
    """The 2-D tensor map (K, rows) of a row-major (rows, K) GEMM operand:
    boxes of ``box_rows`` rows by 128 bytes of K, swizzled 128 B; rows past
    the end and K past the row read as zeros.  Raises ValueError where the
    TMA cannot take the layout (a K dim that is not contiguous, a base not
    16-byte aligned, a row stride not a multiple of 16 bytes)."""
    _cuda.require(x.dim() == 2 and x.stride(-1) == 1, "a GEMM operand must be (rows, K) with K contiguous")
    _cuda.require(x.dtype in (torch.bfloat16, torch.int8), f"GEMM operands are bfloat16 or int8, got {x.dtype}")
    item = x.element_size()
    row_bytes = x.stride(0) * item
    _cuda.require(row_bytes % 16 == 0 and 0 < row_bytes < 1 << 40, f"row stride {row_bytes} B must be a multiple of 16")
    _cuda.require(x.data_ptr() % 16 == 0, "the operand's base must be 16-byte aligned")
    _cuda.require(1 <= box_rows <= 256, f"box of {box_rows} rows")
    rows, k = x.shape
    return TileMap((k, rows), (row_bytes,), (K_SLICE_BYTES // item, box_rows), K_SLICE_BYTES)


def block_n(m: int, n: int, sms: int = H100_SMS) -> int:
    """The block width of the down pass over an (m, n) output: the one whose
    tiles finish in the least time, counted as waves over the SMs times the
    width (a tile's time grows with its width); ties go to the wider block."""
    row_tiles = -(-m // ROW_TILE)
    return min(BLOCK_NS, key=lambda bn: -(-row_tiles * -(-n // bn) // sms) * bn)


def ffn_workspaces(m: int, c: int, inter: int, int8: bool, device) -> dict:
    """The intermediates of the passes, uninitialised: bf16 xn (M, C) and h (M, I);
    int8 xq (M, C), xs (M,) f32, hmax (M,) 32-bit, hq (M, I)."""
    empty = lambda *shape, dtype: torch.empty(shape, dtype=dtype, device=device)
    if not int8:
        return {"xn": empty(m, c, dtype=torch.bfloat16), "h": empty(m, inter, dtype=torch.bfloat16)}
    return {"xq": empty(m, c, dtype=torch.int8), "xs": empty(m, dtype=torch.float32),
            "hmax": empty(m, dtype=torch.int32), "hq": empty(m, inter, dtype=torch.int8)}


def ffn_tile_maps(a_up: torch.Tensor, w1: torch.Tensor, a_down: torch.Tensor, w2: torch.Tensor,
                  sms: int = H100_SMS, block_ns: Optional[tuple] = None) -> list:
    """Tensor maps of the up pass (A = LN(x) rows (M, C), B = W1 (I, C)) and the
    down pass (A = h (M, I), B = W2 (C, I)), in the C entry points' order.
    ``block_ns`` = (up, down) overrides the block widths (for ablations)."""
    m, c = a_up.shape[0], w2.shape[0]
    up_bn, down_bn = block_ns or (UP_BLOCK_N, block_n(m, c, sms))
    return [operand_map(a_up, ROW_TILE), operand_map(w1, up_bn), operand_map(a_down, ROW_TILE),
            operand_map(w2, down_bn)]


def _sms(device) -> int:
    """The SMs the down pass's block width is balanced over: the CUDA
    device's, or the H100's where the geometry is planned off the card."""
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def _out(x, partial: bool) -> torch.Tensor:
    """The output: like x, or the partial mode's f32 partial sums."""
    return torch.empty(x.shape, dtype=torch.float32, device=x.device) if partial else torch.empty_like(x)


def _bias(b2, n, dtype, device, partial: bool):
    """The down pass's bias vector; the partial mode takes None (a null pointer) on all but one rank."""
    _cuda.require(b2 is not None or partial, "b2 may be None only in the partial mode")
    return None if b2 is None else _vec(b2, n, dtype, device)


def _ln_ffn_bf16_args(x, residual, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, block_ns=None, partial=False):
    """Check the operands and build the argument list of ``ln_ffn_bf16`` (all but ``passes``)."""
    _check_rows(x, residual)
    m, c = x.shape
    inter = w1.shape[0]
    _cuda.require(m <= MAX_ROWS, f"M={m} rows exceed the grid's {MAX_ROWS}")
    _cuda.require(inter % 32 == 0 and w1.shape == (inter, c) and w2.shape == (c, inter),
                  f"W1 must be (I, C) and W2 (C, I) with I a multiple of 32, got {tuple(w1.shape)}, {tuple(w2.shape)}")
    dev, dt = x.device, x.dtype
    w1c, w2c = w1.to(dt).contiguous(), w2.to(dt).contiguous()
    ws = ffn_workspaces(m, c, inter, False, dev)
    maps = ffn_tile_maps(ws["xn"], w1c, ws["h"], w2c, _sms(dev), block_ns)
    tensors = [x, residual, _vec(ln_w, c, dt, dev), _vec(ln_b, c, dt, dev), w1c, _vec(b1, inter, dt, dev), w2c,
               _bias(b2, c, dt, dev, partial), _gamma(gamma, x).contiguous(), _out(x, partial), ws["xn"], ws["h"]]
    args = [*map(_cuda.ptr, tensors), _cuda.c_int(m), _cuda.c_int(c), _cuda.c_int(inter), _cuda.c_float(eps),
            *(g.as_c() for g in maps)]
    return args, tensors, f"{c}x{inter}"


def _ln_ffn_int8_args(x, residual, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, gamma, eps, block_ns=None, partial=False):
    """Check the operands and build the argument list of ``ln_ffn_int8`` (all but ``passes``)."""
    _check_rows(x, residual)
    m, c = x.shape
    inter = w1q.shape[0]
    _cuda.require(m <= MAX_ROWS, f"M={m} rows exceed the grid's {MAX_ROWS}")
    _cuda.require(inter % 64 == 0 and w1q.shape == (inter, c) and w2q.shape == (c, inter)
                  and w1q.dtype == torch.int8 and w2q.dtype == torch.int8
                  and w1q.is_contiguous() and w2q.is_contiguous(),
                  "W1q must be contiguous int8 (I, C) and W2q (C, I), I a multiple of 64")
    dev, dt = x.device, x.dtype
    ws = ffn_workspaces(m, c, inter, True, dev)
    maps = ffn_tile_maps(ws["xq"], w1q, ws["hq"], w2q, _sms(dev), block_ns)
    tensors = [x, residual, _vec(ln_w, c, dt, dev), _vec(ln_b, c, dt, dev), w1q, _vec(s1, inter, torch.float32, dev),
               _vec(b1, inter, dt, dev), w2q, _vec(s2, c, torch.float32, dev), _bias(b2, c, dt, dev, partial),
               _gamma(gamma, x).contiguous(), _out(x, partial), ws["xq"], ws["xs"], ws["hmax"], ws["hq"]]
    args = [*map(_cuda.ptr, tensors), _cuda.c_int(m), _cuda.c_int(c), _cuda.c_int(inter), _cuda.c_float(eps),
            *(g.as_c() for g in maps)]
    return args, tensors, f"{c}x{inter}"


def _dw_taps(block, dt):
    """Depthwise weight (C, 1, 7) -> (7, C) and bias, cast to the activation dtype."""
    return block.dwconv.weight[:, 0, :].t().to(dt), block.dwconv.bias.to(dt)


def frame_bound(frame_valid, t: int, device) -> torch.Tensor:
    """The edge as the int32 (1,) tensor that the row kernels with a depthwise
    conv (B4's, and B2's and B3's folded rows pass) read on the device:
    ``frame_valid`` clipped to [0, T].  ``frame_valid`` is None (T), an int
    (>= 0), or a tensor on ``device`` (a chunk width that a CUDA graph takes
    as an input: clipped there, with no host read)."""
    if isinstance(frame_valid, torch.Tensor):
        _cuda.require(frame_valid.numel() == 1 and frame_valid.device == device,
                      f"a frame_valid tensor must hold one value on {device}")
        return frame_valid.reshape(1).clamp(0, t).to(torch.int32)
    fv = t if frame_valid is None else int(frame_valid)
    _cuda.require(fv >= 0, f"frame_valid must be >= 0, got {fv}")
    return torch.full((1,), min(fv, t), dtype=torch.int32, device=device)


def _convnext_dw_args(x, block, frame_valid=None, eps=1e-6, b2=None, block_ns=None, partial=False):
    """Check the operands and build the argument list of ``convnext_dw_bf16``
    (all but ``passes``) for x (B, T, C) on any device (``meta`` plans it
    with no storage): the rows pass writes xn over B*T rows, then B2's up
    and down passes run on the workspaces.  The down pass adds pwconv2's
    bias, or in the partial mode ``b2`` (None: no bias).  The edge goes to
    the kernel as a device int32 (``frame_bound``), the last of the tensors."""
    _cuda.require(x.dtype == torch.bfloat16, f"ConvNeXt kernel takes bfloat16, got {x.dtype}")
    _cuda.require(x.dim() == 3, "x must be a (B, T, C) tensor")
    x = x.contiguous()  # the first block's input is a transposed view of the embedding conv's output
    b, t, c = x.shape
    _cuda.require(c % 64 == 0 and 64 <= c <= 768, f"C={c} must be a multiple of 64 up to 768")
    inter = block.pwconv1.weight.shape[0]
    _cuda.require(inter % 32 == 0, f"I={inter} must be a multiple of 32")
    _cuda.require(1 <= b * t <= MAX_ROWS, f"B*T={b * t} rows must be 1..{MAX_ROWS}")
    dev, dt = x.device, x.dtype
    bound = frame_bound(frame_valid, t, dev)
    dw_w, dw_b = _dw_taps(block, dt)
    w1, w2 = block.pwconv1.weight.to(dt).contiguous(), block.pwconv2.weight.to(dt).contiguous()
    ws = ffn_workspaces(b * t, c, inter, False, dev)
    maps = ffn_tile_maps(ws["xn"], w1, ws["h"], w2, _sms(dev), block_ns)
    tensors = [x, dw_w.contiguous(), _vec(dw_b, c, dt, dev), _vec(block.norm.weight, c, dt, dev),
               _vec(block.norm.bias, c, dt, dev), w1, _vec(block.pwconv1.bias, inter, dt, dev), w2,
               _bias(b2 if partial else block.pwconv2.bias, c, dt, dev, partial),
               _vec(block.gamma, c, dt, dev), _out(x, partial), ws["xn"], ws["h"], bound]
    args = [*map(_cuda.ptr, tensors[:-1]), *map(_cuda.c_int, (b, t, c, inter)), _cuda.ptr(bound), _cuda.c_float(eps),
            *(g.as_c() for g in maps)]
    return args, tensors, f"{c}x{inter}"


def _folded_args(int8: bool, x, block, bound, eps=1e-6, block_ns=None):
    """Check the operands and build the argument list of ``ln_ffn_int8_dw``
    (``int8``: ``ops.quant.quantize_stacked_convnext``'s weights) or
    ``ln_ffn_bf16_dw`` (all but ``passes``) for a Vocos ConvNeXt block's input
    x (B, T, C) on any device (``meta`` plans it): ``ln_ffn_int8``'s or
    ``ln_ffn_bf16``'s over the B T rows with x as the residual, then the
    depthwise taps (7, C), its bias, the edge ``bound`` (``frame_bound``'s
    device int32), B and T.  The tensors are the unfolded kind's, at the same
    places, with the conv's three after them."""
    _cuda.require(x.dtype == torch.bfloat16 and x.dim() == 3, "x must be a bfloat16 (B, T, C) tensor")
    _cuda.require(isinstance(bound, torch.Tensor) and bound.shape == (1,) and bound.dtype == torch.int32
                  and bound.device == x.device, f"bound must be frame_bound's int32 (1,) on {x.device}")
    x = x.contiguous()  # the first block's input is a transposed view of the embedding conv's output
    b, t, c = x.shape
    rows = x.view(b * t, c)
    norm, pw1, pw2 = block.norm, block.pwconv1, block.pwconv2
    if int8:
        args, tensors, shape = _ln_ffn_int8_args(rows, rows, norm.weight, norm.bias, block.pw1_q, block.pw1_s, pw1.bias,
                                                 block.pw2_q, block.pw2_s, pw2.bias, block.gamma, eps, block_ns)
    else:
        args, tensors, shape = _ln_ffn_bf16_args(rows, rows, norm.weight, norm.bias, pw1.weight, pw1.bias, pw2.weight,
                                                 pw2.bias, block.gamma, eps, block_ns)
    dw_w, dw_b = _dw_taps(block, x.dtype)
    conv = [dw_w.contiguous(), _vec(dw_b, c, x.dtype, x.device), bound]
    return [*args, *map(_cuda.ptr, conv), _cuda.c_int(b), _cuda.c_int(t)], tensors + conv, shape


_FFN = {  # kind -> (library, C entry point, launch-count key, argument-list function, passes, index of ``out`` among the tensors)
    "bf16": ("ln_ffn", "ln_ffn_bf16", "ln_ffn_bf16", _ln_ffn_bf16_args, BF16_PASSES, 9),
    "int8": ("ln_ffn_int8", "ln_ffn_int8", "ln_ffn_int8", _ln_ffn_int8_args, INT8_PASSES, 11),
    "dw": ("convnext_dw", "convnext_dw_bf16", "convnext_dw", _convnext_dw_args, BF16_PASSES, 10),
    "bf16-partial": ("ln_ffn", "ln_ffn_bf16", "ln_ffn_bf16_partial", functools.partial(_ln_ffn_bf16_args, partial=True),
                     BF16_PARTIAL_PASSES, 9),
    "int8-partial": ("ln_ffn_int8", "ln_ffn_int8", "ln_ffn_int8_partial",
                     functools.partial(_ln_ffn_int8_args, partial=True), INT8_PARTIAL_PASSES, 11),
    "dw-partial": ("convnext_dw", "convnext_dw_bf16", "convnext_dw_partial",
                   functools.partial(_convnext_dw_args, partial=True), BF16_PARTIAL_PASSES, 10),
    # a Vocos block's chain with its depthwise conv in the rows pass, counted under the unfolded key
    "int8-folded": ("ln_ffn_int8", "ln_ffn_int8_dw", "ln_ffn_int8", functools.partial(_folded_args, True),
                    INT8_PASSES, 11),
    "bf16-folded": ("ln_ffn", "ln_ffn_bf16_dw", "ln_ffn_bf16", functools.partial(_folded_args, False),
                    BF16_PASSES, 9),
}
# the Vocos block impl -> the kind that runs it with the conv folded in (a CUDA x, no model group)
FOLDED_KINDS = {"int8": "int8-folded", "fused": "bf16-folded"}


def _ffn_launch(kind: str, *operands, reduce_max=None, **build_kw):
    """Launch every pass of ``kind`` on the operands, counted once.  With
    ``reduce_max`` (B3's partial mode under a model group) the rows and
    up-max passes launch first, uncounted, then ``reduce_max`` reduces the
    hmax workspace in place, then the remaining passes launch, counted."""
    lib, fn, key, build, passes, out_index = _FFN[kind]
    args, tensors, shape = build(*operands, **build_kw)
    stream = _cuda.stream(tensors[0].device)
    todo = sum(passes.values())
    if reduce_max is not None:
        first = passes["rows"] | passes["up_max"]
        _cuda.launch(lib, fn, None, *args, _cuda.c_int(first), stream)
        reduce_max(tensors[HMAX_INDEX])
        todo -= first
    _cuda.launch(lib, fn, f"{key}:{shape}", *args, _cuda.c_int(todo), stream)
    return tensors[out_index]


def ffn_passes(kind: str, *operands, block_ns: Optional[tuple] = None):
    """(pass name -> a callable that launches that pass alone on
    ``operands``, the tensors they run on): the wrapper's arguments (CUDA
    tensors) as the argument-list function of ``kind`` checks them, for
    timing each pass and reading its workspaces.  The passes share one set
    of workspaces, which the callables keep alive, so run them in order once
    before timing one alone.  These launches bypass the wrapper and are not
    counted.  ``block_ns`` as in ``ffn_tile_maps``."""
    lib, fn, _, build, passes, _ = _FFN[kind]
    args, tensors, _ = build(*operands, block_ns=block_ns)
    stream = _cuda.stream(tensors[0].device)
    entry = getattr(_cuda.library(lib), fn)
    entry.restype = ctypes.c_int
    entry.argtypes = [type(a) for a in args] + [ctypes.c_int, ctypes.c_void_p]

    def run_pass(bit, tensors=tensors):  # the default keeps the workspaces alive with the callables
        err = entry(*args, bit, stream)
        if err != 0:
            raise RuntimeError(f"{fn} pass {bit} failed: CUDA error {err}")

    return {name: functools.partial(run_pass, bit) for name, bit in passes.items()}, tensors


def rank_bias(b2, first: bool):
    """The partial down pass's bias on a model rank: b2 on the group's first
    rank, None (no bias) on the others, so the reduced sum holds it once."""
    return b2 if first else None


def _first_rank(group) -> bool:
    return dist.get_rank(group) == 0


def _sum_and_residual(part: torch.Tensor, residual: torch.Tensor, group) -> torch.Tensor:
    """bf16(residual + the model group's sum of the f32 partials): one rounding, as the unsharded kernel's."""
    dist.all_reduce(part, group=group)
    return (residual.to(torch.float32) + part).to(residual.dtype)


def ln_ffn_partial(x, ln_w, ln_b, w1, b1, w2, b2=None, gamma=None, eps=1e-6):
    """Partial mode of B2 on this rank's slice of I: f32 (M, C) as
    ``fused_ln_ffn_partial_plain``.  A CUDA tensor runs ``csrc/ln_ffn.cu``'s
    rows, up and partial down passes (one launch count)."""
    if x.device.type == "cpu":
        return fused_ln_ffn_partial_plain(x, ln_w, ln_b, w1, b1, w2, b2, gamma, eps)
    return _ffn_launch("bf16-partial", x, x, ln_w, ln_b, w1, b1, w2, b2, gamma, eps)


def ln_ffn_int8_partial(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2=None, gamma=None, eps=1e-6, reduce_max=None):
    """Partial mode of B3 on this rank's slice of I: f32 (M, C) as
    ``fused_ln_ffn_int8_partial_plain``; ``reduce_max`` (in place, on the
    int32 view of the rows' |h| max) runs between the up-max and the
    up-quantise passes.  A CUDA tensor runs ``csrc/ln_ffn_int8.cu``'s
    passes in one launch without ``reduce_max``, two with it (one launch
    count either way)."""
    if x.device.type == "cpu":
        return fused_ln_ffn_int8_partial_plain(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, gamma, eps, reduce_max)
    return _ffn_launch("int8-partial", x, x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, gamma, eps,
                       reduce_max=reduce_max)


def fused_ln_ffn(x, residual, ln_w, ln_b, w1, b1, w2, b2, gamma=None, eps=1e-6, group=None):
    """Fused residual + gamma * (GELU_tanh(LN(x) W1^T + b1) W2^T + b2) over (M, C) rows.

    gamma=None is the transformer FFN (gamma = 1, residual = x); the Vocos
    ConvNeXt chain passes its layer scale and the block input as residual.
    A CUDA tensor runs ``csrc/ln_ffn.cu``'s three passes (one launch count).
    With a model ``group`` the weights are this rank's slice of I: the
    partial mode, reduced over the group (see the module docstring).
    """
    if group is not None:
        part = ln_ffn_partial(x, ln_w, ln_b, w1, b1, w2, rank_bias(b2, _first_rank(group)), gamma, eps)
        return _sum_and_residual(part, residual, group)
    if x.device.type == "cpu":
        return fused_ln_ffn_plain(x, residual, ln_w, ln_b, w1, b1, w2, b2, gamma, eps)
    return _ffn_launch("bf16", x, residual, ln_w, ln_b, w1, b1, w2, b2, gamma, eps)


def fused_convnext_ffn(xdw: torch.Tensor, residual: torch.Tensor, block, eps: float = 1e-6,
                       group=None) -> torch.Tensor:
    """ConvNeXt pointwise chain of one Vocos block (norm, pwconv1, pwconv2, gamma)."""
    return fused_ln_ffn(xdw, residual, block.norm.weight, block.norm.bias,
                        block.pwconv1.weight, block.pwconv1.bias, block.pwconv2.weight, block.pwconv2.bias,
                        block.gamma, eps=eps, group=group)


def fused_ln_ffn_int8(x, residual, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, gamma=None, eps=1e-6, group=None):
    """int8 ``fused_ln_ffn`` with pre-quantised weights (ops/quant.py) and
    per-row dynamic activation quantisation inside the kernel.  A CUDA
    tensor runs ``csrc/ln_ffn_int8.cu``'s four passes (one launch count).
    With a model ``group``: the partial mode, the rows' |h| max all-reduced
    (MAX) over the group between the up passes."""
    if group is not None:
        reduce_max = functools.partial(dist.all_reduce, op=dist.ReduceOp.MAX, group=group)
        part = ln_ffn_int8_partial(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, rank_bias(b2, _first_rank(group)),
                                   gamma, eps, reduce_max)
        return _sum_and_residual(part, residual, group)
    if x.device.type == "cpu":
        return fused_ln_ffn_int8_plain(x, residual, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, gamma, eps)
    return _ffn_launch("int8", x, residual, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, gamma, eps)


def fused_convnext_block(x: torch.Tensor, block, impl: str, bound: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """A Vocos ConvNeXt block in ``impl`` "int8" (B3, ``csrc/ln_ffn_int8.cu``)
    or "fused" (B2, ``csrc/ln_ffn.cu``) on a CUDA x (B, T, C), with its masked
    depthwise conv folded into the rows pass (``csrc/dw_rows.cuh``): bit for
    bit what x times the edge mask, ``ops.conv.depthwise_conv1d_shifts`` and
    then ``fused_ln_ffn_int8`` / ``fused_convnext_ffn`` (residual x) give on
    the card, with no xdw in device memory.  ``bound`` is ``frame_bound``'s
    device int32 (a Vocos forward makes it once for its blocks).  One launch
    count under the unfolded kernel's key; any other device raises
    ValueError (the CPU runs the plain chain, ``models/vocos.py``)."""
    _cuda.require(impl in FOLDED_KINDS, f"impl must be one of {tuple(FOLDED_KINDS)}, got {impl!r}")
    return _ffn_launch(FOLDED_KINDS[impl], x, block, bound, eps).view(x.shape)


def _dw_sum_plain(x: torch.Tensor, block, frame_valid) -> torch.Tensor:
    """B4's depthwise sum on x (B, T, C) as (B T, C) f32: rows outside
    [0, frame_valid) zeroed, summed from the bias with taps 0..6 in order.
    ``frame_valid`` is None (T), an int or a one-value tensor, as the kernel's."""
    b, t, c = x.shape
    fv = t if frame_valid is None else frame_valid
    valid = (torch.arange(t, device=x.device) < fv)[None, :, None]
    xp = F.pad(torch.where(valid, x.to(torch.float32), 0.0), (0, 0, 3, 3))
    w, bias = (z.to(torch.float32) for z in _dw_taps(block, x.dtype))
    xdw = bias.expand(b, t, c)
    for k in range(7):
        xdw = xdw + xp[:, k:k + t] * w[k]
    return xdw.reshape(b * t, c)


def fused_convnext_block_dw_plain(x: torch.Tensor, block, frame_valid=None, eps: float = 1e-6) -> torch.Tensor:
    """The B4 kernel's function step by step on x (B, T, C): rows outside
    [0, frame_valid) zeroed, depthwise k7 summed in f32 from the bias with
    taps 0..6 in order, the bf16 chain on that f32 sum (no rounding before
    the LayerNorm), residual = the unmasked x."""
    b, t, c = x.shape
    return _ln_ffn_chain_plain(_dw_sum_plain(x, block, frame_valid), x.reshape(b * t, c), block.norm.weight,
                               block.norm.bias, block.pwconv1.weight, block.pwconv1.bias, block.pwconv2.weight,
                               block.pwconv2.bias, block.gamma, eps, x.dtype).reshape(b, t, c)


def fused_convnext_block_dw_partial_plain(x: torch.Tensor, block, frame_valid=None, eps: float = 1e-6,
                                          b2=None) -> torch.Tensor:
    """Partial mode of B4, step by step: the depthwise sum and LN of the
    whole (replicated) C, then the f32 gamma (h W2^T + b2) of this rank's
    slice of I, ``b2`` (pwconv2's bias) on one rank only (None elsewhere),
    no residual; (B, T, C) f32."""
    b, t, c = x.shape
    return _ln_ffn_y_plain(_dw_sum_plain(x, block, frame_valid), block.norm.weight, block.norm.bias,
                           block.pwconv1.weight, block.pwconv1.bias, block.pwconv2.weight, b2, block.gamma, eps,
                           x.dtype).reshape(b, t, c)


def convnext_dw_partial(x: torch.Tensor, block, frame_valid=None, eps: float = 1e-6, b2=None):
    """Partial mode of B4 on this rank's slice of I: f32 (B, T, C) as
    ``fused_convnext_block_dw_partial_plain``.  A CUDA tensor runs
    ``csrc/convnext_dw.cu``'s rows, up and partial down passes (one launch count)."""
    if x.device.type == "cpu":
        return fused_convnext_block_dw_partial_plain(x, block, frame_valid, eps, b2)
    _cuda.require(x.device.type == "cuda", f"unsupported device {x.device}")
    return _ffn_launch("dw-partial", x, block, frame_valid, eps, b2)


def fused_convnext_block_dw(x: torch.Tensor, block, frame_valid=None, eps: float = 1e-6,
                            group=None) -> torch.Tensor:
    """Whole ConvNeXt block of one Vocos layer (depthwise k7 conv with the
    ``frame_valid`` edge mask, LN, pwconv1, GELU, pwconv2, gamma, residual)
    on x (B, T, C).  Any T; ``frame_valid`` is None (T), an int or a
    one-value tensor on x's device (read by the kernel there).  A CUDA tensor
    runs ``csrc/convnext_dw.cu``'s three passes (one launch count).  With a
    model ``group``: the partial mode (the depthwise + LN rows pass runs
    whole on every rank), reduced over the group, the block input added
    after the reduction."""
    if group is not None:
        b2 = rank_bias(block.pwconv2.bias, _first_rank(group))
        return _sum_and_residual(convnext_dw_partial(x, block, frame_valid, eps, b2), x, group)
    if x.device.type == "cpu":
        return fused_convnext_block_dw_plain(x, block, frame_valid, eps)
    _cuda.require(x.device.type == "cuda", f"unsupported device {x.device}")
    return _ffn_launch("dw", x, block, frame_valid, eps)
