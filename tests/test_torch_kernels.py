"""The plain versions of the port's CUDA kernels vs the JAX Pallas kernels.

The JAX kernels run in interpret mode on the CPU (as the JAX package's own
tests run them); the port's wrappers run their plain versions for CPU
tensors.  Everything is float32 here, so the point is the algorithm; the
CUDA kernels themselves are held against these plain versions on the GPU by
``chip_smoke.py``.  Tolerances are those of tests/test_flash_attention.py
and tests/test_fused_kernel.py (atol 2e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simwhisper_codec_tpu.ops import flash_attention as jfa
from simwhisper_codec_tpu.ops import fused_convnext as jfc
from simwhisper_codec_tpu.ops.quant import quantize_weight as jquantize_weight
from simwhisper_codec_tpu_torch.models.vocos import ConvNeXtBlock
from simwhisper_codec_tpu_torch.ops import _cuda
from simwhisper_codec_tpu_torch.ops import flash_attention as tfa
from simwhisper_codec_tpu_torch.ops import fused_convnext as tfc
from simwhisper_codec_tpu_torch.ops.quant import quantize_weight

from torch_port import n, t


@pytest.mark.parametrize("heads,hd", [(4, 16), (2, 64)])
def test_pflash_plain_matches_jax_kernel(heads, hd):
    """Ragged lengths, T not a multiple of any block, one length-0 row."""
    rng = np.random.default_rng(0)
    b, tt = 3, 203
    qkv = (rng.standard_normal((b, tt, 3 * heads * hd)) * 0.5).astype(np.float32)
    lengths = np.array([203, 77, 0], np.int32)
    want = jfa.fused_qkv_attention(jnp.asarray(qkv), jnp.asarray(lengths), heads, block_q=64, interpret=True)
    got = tfa.fused_qkv_attention(t(qkv), t(lengths), heads)
    assert got.shape == (b, tt, heads * hd)
    # rows of length-0 entries: the JAX kernel averages over its padded keys
    # and the port over the T real ones; both are dropped downstream
    for i in np.nonzero(lengths > 0)[0]:
        np.testing.assert_allclose(n(got)[i], n(want)[i], atol=2e-5)
    assert np.isfinite(n(got)).all()


def test_pflash_length0_row_is_uniform_average():
    rng = np.random.default_rng(1)
    qkv = rng.standard_normal((1, 40, 3 * 32)).astype(np.float32)
    got = n(tfa.fused_qkv_attention(t(qkv), t(np.array([0], np.int32)), 2))
    v = qkv[0, :, 64:]
    np.testing.assert_allclose(got[0], np.broadcast_to(v.mean(0), got[0].shape), atol=1e-6)


def _ffn_params(rng, c, inter):
    return dict(
        ln_w=(1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
        ln_b=(0.1 * rng.standard_normal(c)).astype(np.float32),
        w1=(rng.standard_normal((c, inter)) * 0.05).astype(np.float32),  # JAX layout (in, out)
        b1=(rng.standard_normal(inter) * 0.05).astype(np.float32),
        w2=(rng.standard_normal((inter, c)) * 0.05).astype(np.float32),
        b2=(rng.standard_normal(c) * 0.05).astype(np.float32),
        gamma=(0.1 * rng.standard_normal(c)).astype(np.float32),
    )


@pytest.mark.parametrize("with_gamma,separate_residual", [(True, True), (False, False), (True, False)])
def test_ln_ffn_plain_matches_jax_kernel(with_gamma, separate_residual):
    rng = np.random.default_rng(2)
    m, c, inter = 300, 64, 256  # m not a block multiple
    p = _ffn_params(rng, c, inter)
    x = rng.standard_normal((m, c)).astype(np.float32)
    res = rng.standard_normal((m, c)).astype(np.float32) if separate_residual else x
    gamma = p["gamma"] if with_gamma else None
    want = jfc.fused_ln_ffn(jnp.asarray(x), jnp.asarray(res), p["ln_w"], p["ln_b"], p["w1"], p["b1"],
                            p["w2"], p["b2"], None if gamma is None else jnp.asarray(gamma),
                            eps=1e-6, block_m=128, interpret=True)
    got = tfc.fused_ln_ffn(t(x), t(res), t(p["ln_w"]), t(p["ln_b"]), t(p["w1"].T), t(p["b1"]),
                           t(p["w2"].T), t(p["b2"]), None if gamma is None else t(gamma), eps=1e-6)
    np.testing.assert_allclose(n(got), n(want), atol=2e-5)


@pytest.mark.parametrize("separate_residual", [False, True])
def test_ln_ffn_int8_plain_matches_jax_kernel(separate_residual):
    rng = np.random.default_rng(3)
    m, c, inter = 80, 128, 256  # m not a block multiple
    p = _ffn_params(rng, c, inter)
    p["ln_b"][:] = 0.0  # so the all-zero row normalises to zero and takes the scale-1 branch
    x = (rng.standard_normal((m, c)) * 0.5).astype(np.float32)
    x[5] = 0.0
    res = rng.standard_normal((m, c)).astype(np.float32) if separate_residual else x
    w1q, s1 = jquantize_weight(jnp.asarray(p["w1"]))
    w2q, s2 = jquantize_weight(jnp.asarray(p["w2"]))
    want = jfc.fused_ln_ffn_int8(jnp.asarray(x), jnp.asarray(res), p["ln_w"], p["ln_b"], w1q, s1, p["b1"],
                                 w2q, s2, p["b2"], jnp.asarray(p["gamma"]), eps=1e-5, block_m=64,
                                 interpret=True)
    tw1q, ts1 = quantize_weight(t(p["w1"].T))
    tw2q, ts2 = quantize_weight(t(p["w2"].T))
    # the port's int8 weights are the JAX package's, transposed to (out, in)
    np.testing.assert_array_equal(n(tw1q), n(w1q).T)
    np.testing.assert_array_equal(n(ts2), n(s2))
    got = tfc.fused_ln_ffn_int8(t(x), t(res), t(p["ln_w"]), t(p["ln_b"]), tw1q, ts1, t(p["b1"]),
                                tw2q, ts2, t(p["b2"]), t(p["gamma"]), eps=1e-5)
    np.testing.assert_allclose(n(got), n(want), atol=2e-5)
    assert np.isfinite(n(got)[5]).all()


def test_int8_plain_product_is_exact():
    """127^2 * 4096 exceeds float32's exact integers; the plain product must not round."""
    a = torch.full((1, 4096), 127.0)
    w = torch.full((1, 4096), 127, dtype=torch.int8)
    w[0, 0] = 126
    exact = 127 * 127 * 4096 - 127
    assert tfc._int_matmul(a, w).item() == float(np.float32(exact))  # one rounding, at the final cast


def test_wrappers_raise_on_unsupported_devices():
    """No fallback: a tensor that is neither on the CPU nor on a CUDA device is refused."""
    x = torch.empty((4, 64), device="meta")
    with pytest.raises(ValueError):
        tfc.fused_ln_ffn(x, x, x[0], x[0], x, x[0], x, x[0])
    with pytest.raises(ValueError):
        tfa.fused_qkv_attention(torch.empty((1, 8, 96), device="meta"), torch.zeros(1, dtype=torch.int32), 2)
    q = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        tfc.fused_convnext_block_dw(torch.empty((1, 40, 64), device="meta"), ConvNeXtBlock(64, 128, 0.1).to("meta"))


def test_kernel_sources_and_launch_counts():
    """Every kernel source exists; CPU calls launch nothing and count nothing."""
    assert set(_cuda.SOURCES) == {"pflash", "ln_ffn", "ln_ffn_int8", "flash", "convnext_dw", "attn_f32"}
    for name in _cuda.SOURCES:
        assert (_cuda.CSRC_DIR / f"{name}.cu").exists()
    _cuda.reset_launch_counts()
    x = torch.randn(8, 64)
    tfc.fused_ln_ffn(x, x, torch.ones(64), torch.zeros(64), torch.randn(128, 64), torch.zeros(128),
                     torch.randn(64, 128), torch.zeros(64))
    q = torch.randn(1, 2, 8, 16)
    tfa.flash_attention(q, q, q, torch.tensor([5]))
    with torch.no_grad():
        tfc.fused_convnext_block_dw(torch.randn(1, 8, 64), ConvNeXtBlock(64, 128, 0.1), frame_valid=6)
    assert dict(_cuda.launch_counts) == {}
