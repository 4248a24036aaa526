"""The port's ``packed`` and ``chunked`` attention impls against the JAX package's.

``models/transformer.py::packed_attention`` / ``chunked_attention`` against
``simwhisper_codec_tpu/models/transformer.py``'s, on one TINY encoder
layer's weights, x (3, 200, 64) with ragged lengths (200, 77) and a
length-0 row (whose queries average every value): f32 activations with f32
scores at HIGHEST precision within 2e-5 (the layer tolerance of
``tests/test_torch_codec.py``); bf16 activations with f32 or bf16 scores
within |d| <= 1.6e-2 max|JAX| (two bf16 half-ulps relative, phase 2's bf16
kernel tolerance; the two frameworks round the projections, the weights
and the bf16 softmax's steps at other places: measured 4.2e-3, one bf16
ulp of the largest output).  ``block_q`` 128 and 96 (neither divides T = 200, so the
query is padded) and 200.  Then the JAX spellings through ``mode_programs``
and a whole layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simwhisper_codec_tpu.models import transformer as jtransformer
from simwhisper_codec_tpu_torch.models import codec as tcodec
from simwhisper_codec_tpu_torch.models import transformer as ttransformer

from torch_port import HIGHEST, TINY, jax_params, n, port_model, t

LENGTHS = np.array([200, 77, 0])
BF16_REL = 1.6e-2


@pytest.fixture(scope="module")
def layer():
    params = jax_params(0)
    return jax.tree.map(lambda a: a[0], params["encoder"]["layers"]), port_model(params).acoustic_encoder.layers[0]


def _x():
    return (np.random.default_rng(21).standard_normal((3, 200, TINY.acoustic_encoder.d_model)) * 0.5).astype(np.float32)


def _check(got, want, dtype):
    got, want = n(got.to(torch.float32)), np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    else:
        assert float(np.abs(got - want).max()) <= BF16_REL * float(np.abs(want).max())


@pytest.mark.parametrize("dtype,score", [("float32", "float32"), ("bfloat16", "float32"), ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("block_q", [128, 96, 200])
def test_chunked_matches_jax(layer, dtype, score, block_q):
    jp, tl = layer
    x = _x()
    heads = TINY.acoustic_encoder.encoder_attention_heads
    want = jtransformer.chunked_attention(jp, jnp.asarray(x).astype(dtype), jnp.asarray(LENGTHS), heads, HIGHEST,
                                          block_q=block_q, score_dtype=getattr(jnp, score))
    with torch.no_grad():
        got = ttransformer.chunked_attention(tl.self_attn, t(x).to(getattr(torch, dtype)), t(LENGTHS), block_q,
                                             getattr(torch, score))
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype,score", [("float32", "float32"), ("bfloat16", "float32"), ("bfloat16", "bfloat16")])
def test_packed_matches_jax(layer, dtype, score):
    jp, tl = layer
    x = _x()
    heads = TINY.acoustic_encoder.encoder_attention_heads
    want = jtransformer.packed_attention(jp, jnp.asarray(x).astype(dtype), jnp.asarray(LENGTHS), heads, HIGHEST,
                                         score_dtype=getattr(jnp, score))
    with torch.no_grad():
        got = ttransformer.packed_attention(tl.self_attn, t(x).to(getattr(torch, dtype)), t(LENGTHS),
                                            getattr(torch, score))
    _check(got, want, dtype)


@pytest.mark.parametrize("spelling", ["packed", "packed:bf16", "chunked", "chunked:96", "chunked:1536:bf16"])
def test_layer_with_xla_impl_matches_jax(layer, spelling):
    """A whole f32 encoder layer (dispatch by the JAX spelling) against
    ``transformer_layer`` with the same spelling, on the valid rows."""
    jp, tl = layer
    x = _x()
    heads = TINY.acoustic_encoder.encoder_attention_heads
    want = jtransformer.transformer_layer(jp, jnp.asarray(x), None, heads, precision=HIGHEST,
                                          lengths=jnp.asarray(LENGTHS), attn_impl=spelling)
    with torch.no_grad():
        got = tl(t(x), None, t(LENGTHS), spelling)
    tol = 2e-5 if "bf16" not in spelling else BF16_REL * float(np.abs(np.asarray(want)).max())
    for bi, ln in enumerate(LENGTHS):
        np.testing.assert_allclose(n(got)[bi, :ln], np.asarray(want)[bi, :ln], atol=tol, rtol=0)


def test_spellings_through_mode_programs(layer):
    parse = ttransformer.parse_attn_impl
    assert parse("pflash:768") == ("pflash", {}) and parse("flash") == ("flash", {})
    assert parse("packed") == ("packed", {"score_dtype": torch.float32})
    assert parse("packed:bf16") == ("packed", {"score_dtype": torch.bfloat16})
    assert parse("chunked") == ("chunked", {"block_q": 128, "score_dtype": torch.float32})
    assert parse("chunked:1536:bf16") == ("chunked", {"block_q": 1536, "score_dtype": torch.bfloat16})
    for spelling in ("pflash:768", "packed:bf16", "chunked:1536:bf16", "chunked:64", "packed", "chunked"):
        tok, detok = tcodec.mode_programs("fast", attn_impl=spelling)
        assert tok["attn_impl"] == detok["attn_impl"] == spelling
        assert tcodec.mode_programs("parity", attn_impl=spelling)[0]["attn_impl"] == spelling
    for bad in ("packed:f16", "chunked:0", "chunked:bf16", "chunked:12:bf16:x", "pflash:abc", "pflash:", "flash:1",
                "ring"):
        with pytest.raises(ValueError):
            tcodec.mode_programs("fast", attn_impl=bad)
    # pflash:<block> runs B1 (its plain version here): the block is the TPU tiling only
    _, tl = layer
    x, lens = t(_x()), t(LENGTHS)
    with torch.no_grad():
        assert torch.equal(tl(x, None, lens, "pflash:768"), tl(x, None, lens, "pflash"))
