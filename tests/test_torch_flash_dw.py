"""The plain versions of kernels B5 (``flash_attention``) and B4
(``fused_convnext_block_dw``) vs the JAX Pallas kernels, on the CPU.

The JAX kernels run in interpret mode (as the JAX package's own tests run
them); the port's wrappers run their plain versions for CPU tensors.  All
float32, so the point is the algorithm; ``chip_smoke.py`` holds the CUDA
kernels against these plain versions on the GPU.  Tolerances are those of
tests/test_flash_attention.py (1e-5 core, 2e-5 layer) and
tests/test_fused_kernel.py (2e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simwhisper_codec_tpu.ops import flash_attention as jfa
from simwhisper_codec_tpu.ops import fused_convnext as jfc
from simwhisper_codec_tpu_torch.models.transformer import SelfAttention
from simwhisper_codec_tpu_torch.models.vocos import ConvNeXtBlock
from simwhisper_codec_tpu_torch.ops import flash_attention as tfa
from simwhisper_codec_tpu_torch.ops import fused_convnext as tfc
from simwhisper_codec_tpu_torch.ops.conv import depthwise_conv1d_shifts

from torch_port import n, t


def test_flash_plain_matches_jax_kernel():
    """Ragged lengths, T not a block multiple, and a length-0 batch-padding row."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((3, 3, 200, 32)).astype(np.float32) for _ in range(3))
    lengths = np.array([200, 77, 0], np.int32)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
                               block_q=64, interpret=True)
    got = tfa.flash_attention(t(q), t(k), t(v), t(lengths))
    assert got.shape == q.shape and np.isfinite(n(got)).all()
    # a length-0 row: the JAX kernel averages over its padded keys, the port
    # over the T real ones; such rows are dropped downstream
    for i in np.nonzero(lengths > 0)[0]:
        np.testing.assert_allclose(n(got)[i], n(want)[i], atol=1e-5)


def test_flash_length0_row_is_uniform_average():
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((1, 2, 40, 16)).astype(np.float32) for _ in range(3))
    got = n(tfa.flash_attention(t(q), t(k), t(v), t(np.array([0], np.int32))))
    np.testing.assert_allclose(got[0], np.broadcast_to(v[0].mean(1, keepdims=True), got[0].shape), atol=1e-6)


def test_varlen_attention_flash_matches_jax():
    rng = np.random.default_rng(1)
    b, tt, dm, heads = 2, 96, 64, 4
    x = (rng.standard_normal((b, tt, dm)) * 0.3).astype(np.float32)
    lengths = np.array([96, 50])
    p = {name: {"w": (0.1 * rng.standard_normal((dm, dm))).astype(np.float32)} for name in "qkvo"}
    for name in "qvo":
        p[name]["b"] = (0.1 * rng.standard_normal(dm)).astype(np.float32)
    want = jfa.varlen_attention_flash(p, jnp.asarray(x), jnp.asarray(lengths), heads, interpret=True)
    attn = SelfAttention(dm, heads)
    with torch.no_grad():
        for name, lin in (("q", attn.q_proj), ("k", attn.k_proj), ("v", attn.v_proj), ("o", attn.out_proj)):
            lin.weight.copy_(t(p[name]["w"].T))
            if lin.bias is not None:
                lin.bias.copy_(t(p[name]["b"]))
        got = tfa.varlen_attention_flash(attn, t(x), t(lengths))
    np.testing.assert_allclose(n(got), n(want), atol=2e-5)


def _dw_params(rng, c, inter):
    """A JAX ConvNeXt block tree and the port's ConvNeXtBlock with the same weights."""
    p = {
        "dwconv": {"w": (rng.standard_normal((7, 1, c)) * 0.2).astype(np.float32),
                   "b": (rng.standard_normal(c) * 0.05).astype(np.float32)},
        "norm": {"scale": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                 "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)},
        "pw1": {"w": (rng.standard_normal((c, inter)) * 0.05).astype(np.float32),
                "b": (rng.standard_normal(inter) * 0.05).astype(np.float32)},
        "pw2": {"w": (rng.standard_normal((inter, c)) * 0.05).astype(np.float32),
                "b": (rng.standard_normal(c) * 0.05).astype(np.float32)},
        "gamma": (0.1 * rng.standard_normal(c)).astype(np.float32),
    }
    block = ConvNeXtBlock(c, inter, 0.1)
    with torch.no_grad():
        block.dwconv.weight.copy_(t(np.transpose(p["dwconv"]["w"], (2, 1, 0))))
        block.dwconv.bias.copy_(t(p["dwconv"]["b"]))
        block.norm.weight.copy_(t(p["norm"]["scale"]))
        block.norm.bias.copy_(t(p["norm"]["bias"]))
        block.pwconv1.weight.copy_(t(p["pw1"]["w"].T))
        block.pwconv1.bias.copy_(t(p["pw1"]["b"]))
        block.pwconv2.weight.copy_(t(p["pw2"]["w"].T))
        block.pwconv2.bias.copy_(t(p["pw2"]["b"]))
        block.gamma.copy_(t(p["gamma"]))
    return p, block


# 150: the edge off a tile boundary; 0: no valid row, so every tap reads a zero
# and LN normalises the bias row
@pytest.mark.parametrize("frame_valid", [None, 150, 0])
def test_convnext_block_dw_plain_matches_jax_kernel(frame_valid):
    rng = np.random.default_rng(2)
    b, tt, c, inter = 2, 192, 64, 128  # the JAX kernel tiles T by 96: two tiles and their halos
    p, block = _dw_params(rng, c, inter)
    x = rng.standard_normal((b, tt, c)).astype(np.float32)
    fv = None if frame_valid is None else jnp.int32(frame_valid)
    want = jfc.fused_convnext_block_dw(jnp.asarray(x), p, frame_valid=fv, interpret=True)
    with torch.no_grad():
        got = tfc.fused_convnext_block_dw(t(x), block, frame_valid)
    np.testing.assert_allclose(n(got), n(want), atol=2e-5)


def _two_step(x, block, frame_valid):
    """The composition that B4 fuses: masked depthwise k7, then B2."""
    b, tt, c = x.shape
    fv = tt if frame_valid is None else frame_valid
    mask = (torch.arange(tt) < fv).to(x.dtype)[None, :, None]
    xdw = depthwise_conv1d_shifts(x * mask, block.dwconv.weight[:, 0, :].t(), block.dwconv.bias, padding=3)
    return tfc.fused_convnext_ffn(xdw.reshape(b * tt, c), x.reshape(b * tt, c), block).reshape(b, tt, c)


def test_convnext_block_dw_any_t():
    """T = 203 has no tile size the JAX kernel accepts; the port takes any T.
    Held against the two-step composition: masked f32 depthwise, then B2."""
    rng = np.random.default_rng(3)
    b, tt, c, inter, fv = 2, 203, 64, 96, 170
    _, block = _dw_params(rng, c, inter)
    x = t(rng.standard_normal((b, tt, c)).astype(np.float32))
    with torch.no_grad():
        got = tfc.fused_convnext_block_dw(x, block, fv)
        want = _two_step(x, block, fv)
    np.testing.assert_allclose(n(got), n(want), atol=2e-5)


@pytest.mark.parametrize("tt,frame_valid", [(1, None), (1, 0), (5, None), (5, 3), (5, 0), (5, 9), (40, 0), (40, 57)])
def test_convnext_block_dw_short_t_and_edges(tt, frame_valid):
    """T shorter than the 7-row window (1: one row and six zero halo rows;
    5), no valid row (frame_valid = 0: xdw is the bias) and a bound past T
    (read as T), against the two-step composition; finite everywhere."""
    rng = np.random.default_rng(4)
    _, block = _dw_params(rng, 64, 96)
    x = t(rng.standard_normal((2, tt, 64)).astype(np.float32))
    with torch.no_grad():
        got = tfc.fused_convnext_block_dw(x, block, frame_valid)
        want = _two_step(x, block, frame_valid)
    assert got.shape == x.shape and np.isfinite(n(got)).all()
    np.testing.assert_allclose(n(got), n(want), atol=2e-5)


def test_convnext_block_dw_batch_items_are_independent():
    """A batch of 3 equals each item run alone: an item's depthwise window
    never reaches into its neighbour's rows (the CUDA row kernel indexes its
    halo by (b, t), not by the flattened row).  The items' scales differ by
    10x, so a leaked row would show far above the tolerance."""
    rng = np.random.default_rng(5)
    _, block = _dw_params(rng, 64, 96)
    scale = np.array([1.0, 10.0, 0.1], np.float32)[:, None, None]
    x = t(rng.standard_normal((3, 45, 64)).astype(np.float32) * scale)
    with torch.no_grad():
        got = tfc.fused_convnext_block_dw(x, block, 40)
        alone = torch.cat([tfc.fused_convnext_block_dw(x[i:i + 1], block, 40) for i in range(3)])
    np.testing.assert_allclose(n(got), n(alone), atol=2e-5)
