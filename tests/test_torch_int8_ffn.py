"""The XLA int8 FFN (``ffn_impl="int8"``) and ``ops/quant.py::int8_dynamic_matmul``
against the JAX package's, on the CPU at TINY (2 + 2 layers, width 64):

 - ``quantize_rows`` gives the JAX function's int8 rows and scales (zero
   rows take scale 1; ties at .5 round half to even); the s32 products are
   equal; the f32 result is within 1 ulp of the JAX function's;
 - the CUDA path's row padding (``torch._int_mm`` takes more than 16 rows)
   and its refusal of K or N off a multiple of 8, with ``_int_mm`` stood in
   by the plain product on the CPU;
 - ``encoder_forward(ffn_impl="int8")`` on the same mel, f32 and bf16, within
   the tolerance stated at each test;
 - the codes of ``tokenize(ffn_impl="int8")`` equal the JAX package's, and a
   detokenize with the int8 decoder FFNs matches its waveform;
 - a model group's path (the row max and the s32 sums all-reduced) gives
   the one-process update.
Timing and the cuBLASLt product against its plain version run on the card
(``chip_smoke.py`` phase 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simwhisper_codec_tpu.models import codec as jcodec
from simwhisper_codec_tpu.models import transformer as jtransformer
from simwhisper_codec_tpu.ops import quant as jquant
from simwhisper_codec_tpu_torch.models import codec as tcodec
from simwhisper_codec_tpu_torch.models import transformer as ttransformer
from simwhisper_codec_tpu_torch.ops import quant

from torch_port import HIGHEST, TINY, jax_params, n, port_model, t


def _jax_rows(x):
    """The JAX ``int8_dynamic_matmul``'s row quantisation (ops/quant.py:44-46), as it computes it."""
    xs = jnp.max(jnp.abs(x), axis=-1, keepdims=True).astype(jnp.float32) / 127.0
    xs = jnp.where(xs == 0, 1.0, xs)
    return jnp.round(x.astype(jnp.float32) / xs).astype(jnp.int8), xs


def _operands(rng, m, k, nout, dtype):
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[3] = 0.0  # an all-zero row: scale 1, product 0
    x[5, :4] = [127.0, 0.5, 1.5, -2.5]  # absmax 127: scale 1, so .5 ties land exactly on the grid
    x[5, 4:] = 0.0
    w = (rng.standard_normal((k, nout)) * 0.05).astype(np.float32)
    wq, ws = jquant.quantize_weight(jnp.asarray(w))
    jx = jnp.asarray(x).astype(dtype)
    return jx, wq, ws, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_int8_dynamic_matmul_matches_jax(dtype):
    """Rows and scales equal, s32 products equal, the f32 result within 1 ulp."""
    jx, wq, ws, tx = _operands(np.random.default_rng(0), 40, 64, 48, dtype)
    jxq, jxs = _jax_rows(jx)
    txq, txs = quant.quantize_rows(tx)
    np.testing.assert_array_equal(n(txq), np.asarray(jxq))
    np.testing.assert_array_equal(n(txs), np.asarray(jxs))
    assert n(txs)[3, 0] == 1.0 and n(txq)[3].tolist() == [0] * 64
    assert n(txq)[5, :4].tolist() == [127, 0, 2, -2]  # round half to even, as jnp.round
    twq = torch.from_numpy(np.asarray(wq).T.copy())  # the port's (out, in) layout
    want_s32 = jax.lax.dot_general(jxq, wq, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(n(quant.int8_product(txq, twq)), np.asarray(want_s32))
    got = n(quant.int8_dynamic_matmul(tx, twq, torch.from_numpy(np.array(ws))))
    want = np.asarray(jquant.int8_dynamic_matmul(jx, wq, ws))
    assert got.dtype == np.float32 and not got[3].any()
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got - want) <= ulp), float(np.max(np.abs(got - want) / ulp))


@pytest.mark.parametrize("m", [1, 16, 17, 40])
def test_cuda_product_pads_small_row_counts(monkeypatch, m):
    """``torch._int_mm`` (stood in by the plain product) sees at least 17 rows
    and the second operand as the column-major (K, N) view; the result keeps
    ``m`` rows and equals the plain product."""
    seen = []

    def int_mm(a, b):
        seen.append((tuple(a.shape), b.stride()))
        return quant.int8_product_plain(a, b.t())

    monkeypatch.setattr(torch, "_int_mm", int_mm)
    rng = np.random.default_rng(m)
    xq = torch.from_numpy(rng.integers(-127, 128, (m, 32)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (24, 32)).astype(np.int8))
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: cuda))
    got = quant.int8_product(xq, wq)
    monkeypatch.undo()
    assert seen == [((max(m, 17), 32), (1, 32))]
    assert torch.equal(got, quant.int8_product_plain(xq, wq))


def test_cuda_product_refuses_shapes_off_a_multiple_of_8(monkeypatch):
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: cuda))
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int8_product(torch.zeros(32, 12, dtype=torch.int8), torch.zeros(16, 12, dtype=torch.int8))


@pytest.fixture(scope="module")
def quantized():
    """The JAX tree and the port's model, both with int8 FFN weights on the encoder and the decoder."""
    params = jax_params(0)
    qparams = dict(params)
    for part in ("encoder", "decoder"):
        qparams[part] = dict(params[part], layers=jquant.quantize_stacked_ffn(params[part]["layers"]))
    model = port_model(params)
    quant.quantize_stacked_ffn(model.acoustic_encoder.layers)
    quant.quantize_stacked_ffn(model.acoustic_decoder.layers)
    return qparams, model


# The two packages' f32 LN and GELU differ by ~1e-7 relative.  Where a GELU
# output lies that close to a bf16 rounding boundary its bf16 value flips,
# which moves that row's int8 activation by up to half a step and its
# output row by one step of the second product: at TINY ~20 rows a layer in
# f32.  So the bound is on the share of elements outside (atol, rtol) and on
# the largest difference: (atol, rtol, share, max |d|); bf16 adds the compute
# dtype's rounding in the attention and the residual adds (measured at TINY:
# 1.3 % outside, max 0.020 in f32; 0.15 %, max 0.0625 = two bf16 ulps in bf16).
ENCODER_TOL = {"f32": (2e-4, 1e-4, 0.03, 0.05), "bf16": (3e-2, 1e-2, 0.01, 0.125)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encoder_forward_int8_matches_jax(quantized, dtype):
    qparams, model = quantized
    rng = np.random.default_rng(4)
    mel = rng.standard_normal((2, 3000, TINY.acoustic_encoder.num_mel_bins)).astype(np.float32)
    lens = np.array([3000, 1711])
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want, wlen = jtransformer.encoder_forward(TINY.acoustic_encoder, qparams["encoder"],
                                              jnp.asarray(mel).astype(jdt), jnp.asarray(lens), precision=HIGHEST,
                                              ffn_impl="int8")
    with torch.no_grad():
        got, glen = model.acoustic_encoder(t(mel).to(tdt), t(lens), ffn_impl="int8")
    assert got.dtype == tdt
    np.testing.assert_array_equal(n(glen), np.asarray(wlen))
    atol, rtol, share, max_d = ENCODER_TOL[dtype]
    got, want = n(got.float()), np.asarray(want.astype(jnp.float32))
    d = np.abs(got - want)
    outside = float(np.mean(d > atol + rtol * np.abs(want)))
    assert outside <= share and float(d.max()) <= max_d, (outside, float(d.max()))


def test_tokenize_codes_and_detokenize_match_jax(quantized):
    """f32 compute, one 3 s utterance in a 30 s chunk: the codes equal the JAX
    package's; its int8-decoder waveform within 3e-4 (the f32 kernel tests' bound)."""
    qparams, model = quantized
    rng = np.random.default_rng(12)
    wav = np.zeros((1, TINY.chunk_samples), np.float32)
    wav[0, :48000] = rng.standard_normal(48000) * 0.1
    lens = np.array([48000])
    consts = jcodec.CodecConstants(TINY)
    jtok = jcodec.tokenize(TINY, consts, qparams, jnp.asarray(wav), jnp.asarray(lens), precision=HIGHEST,
                           ffn_impl="int8")
    with torch.no_grad():
        ttok = tcodec.tokenize(model, t(wav), t(lens), ffn_impl="int8")
    codes, clen = np.asarray(jtok["codes"]), np.asarray(jtok["codes_lengths"])
    np.testing.assert_array_equal(n(ttok["codes"]), codes)
    width = int(clen.max())
    jdet = jcodec.detokenize(TINY, consts, qparams, jnp.asarray(codes), jnp.asarray(clen), jnp.int32(width),
                             precision=HIGHEST, ffn_impl="int8")
    with torch.no_grad():
        tdet = tcodec.detokenize(model, t(codes), t(clen), width, ffn_impl="int8")
    keep = width * 1280
    np.testing.assert_allclose(n(tdet["y"])[:, :keep], np.asarray(jdet["y"])[:, :keep], atol=3e-4)


def test_a_model_group_gives_the_whole_product(quantized, tmp_path):
    """Under a model group (a world of one gloo rank here: the collectives
    run) the layer's int8 FFN equals the one-process update bit for bit;
    the cross-rank sums are held by ``tests/test_torch_tp.py``'s ``xla-int8`` run."""
    import torch.distributed as dist

    layer = quantized[1].acoustic_encoder.layers[0]
    xf = torch.from_numpy(np.random.default_rng(9).standard_normal((37, TINY.acoustic_encoder.d_model))
                          .astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        want = layer.int8_ffn(xf)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        layer.model_group = dist.new_group([0])
        with torch.no_grad():
            got = layer.int8_ffn(xf)
    finally:
        layer.model_group = None
        dist.destroy_process_group()
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert "int8" in ttransformer.FFN_IMPLS
