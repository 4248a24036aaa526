"""The port's codec round trip vs the JAX package's, on the CPU at TINY.

(a) parity mode through ``AudioCodec.encode``/``decode``: codes equal,
    waveforms within 5e-3 (PARITY.md:12);
(b) the fast path in float32: the port's pflash and fused LN-FFN plain
    versions vs the JAX kernels in interpret mode: codes equal, waves close;
(c) the same with the int8 FFN impls, and ``fast-int8`` codes == ``fast``
    codes inside the port;
(d) the same with the B5 attention core and the B4 whole-block Vocos kernel;
(e) parity mode with the f32 attention kernels (``attn_impl`` ``pflash`` or
    ``flash``) against the JAX codec with the same arguments;
(f) the precision each mode runs at, and ``f32_precision``'s flags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simwhisper_codec_tpu.models import codec as jcodec
from simwhisper_codec_tpu.models import transformer as jtransformer
from simwhisper_codec_tpu.ops.quant import quantize_stacked_convnext as jq_convnext
from simwhisper_codec_tpu.ops.quant import quantize_stacked_ffn as jq_ffn
from simwhisper_codec_tpu_torch.models import codec as tcodec
from simwhisper_codec_tpu_torch.ops.quant import quantize_stacked_convnext, quantize_stacked_ffn

from torch_port import HIGHEST, TINY, jax_params, n, port_model, t

SR = 16000


@pytest.fixture(scope="module")
def pair():
    params = jax_params(0)
    return params, port_model(params)


@pytest.fixture(scope="module")
def utterances():
    rng = np.random.default_rng(11)
    # 6.3 s (one short chunk) and 41 s (three chunks, the last one 1 s long)
    return [(rng.standard_normal(n_) * 0.1).astype(np.float32) for n_ in (100800, 41 * SR)]


def test_parity_codec_matches_jax(pair, utterances):
    params, model = pair
    jc = jcodec.AudioCodec(TINY, params, batch_size=2, mode="parity")
    tc = tcodec.AudioCodec(TINY, model, batch_size=2, mode="parity", device="cpu")
    jcodes = jc.encode(utterances)["codes_list"]
    tcodes = tc.encode(utterances)["codes_list"]
    for w, a, b in zip(utterances, jcodes, tcodes):
        assert b.shape == (8, len(w) // 1280) and b.dtype == np.int32
        np.testing.assert_array_equal(b, np.asarray(a))
    jw = jc.decode(jcodes)["syn_wav_list"]
    tw = tc.decode(tcodes)["syn_wav_list"]
    for a, b in zip(jw, tw):
        assert b.shape == np.asarray(a).shape
        assert float(np.abs(b - np.asarray(a)).max()) < 5e-3


def _round_trip(params, model, wav, lens, jkw, tkw):
    jtok = jcodec.tokenize(TINY, jcodec.CodecConstants(TINY), params, jnp.asarray(wav), jnp.asarray(lens),
                           precision=HIGHEST, **jkw["tok"])
    with torch.no_grad():
        ttok = tcodec.tokenize(model, t(wav), t(lens), **tkw["tok"])
    codes, clen = np.asarray(jtok["codes"]), np.asarray(jtok["codes_lengths"])
    np.testing.assert_array_equal(n(ttok["codes"]), codes)
    width = int(clen.max())
    jdet = jcodec.detokenize(TINY, jcodec.CodecConstants(TINY), params, jnp.asarray(codes), jnp.asarray(clen),
                             jnp.int32(width), precision=HIGHEST, **jkw["detok"])
    with torch.no_grad():
        tdet = tcodec.detokenize(model, t(codes), t(clen), width, **tkw["detok"])
    keep = width * 1280
    np.testing.assert_allclose(n(tdet["y"])[:, :keep], np.asarray(jdet["y"])[:, :keep], atol=3e-4)


def _one_chunk(seconds=3.0):
    rng = np.random.default_rng(12)
    wav = np.zeros((1, TINY.chunk_samples), np.float32)
    k = int(seconds * SR)
    wav[0, :k] = rng.standard_normal(k) * 0.1
    return wav, np.array([k])


def test_fast_path_f32_matches_jax_kernels(pair):
    """pflash core + fused LN-FFN everywhere (JAX: Pallas interpret mode)."""
    params, model = pair
    wav, lens = _one_chunk()
    jkw = {"tok": dict(attn_impl="pflash:256", fused_ffn=True),
           "detok": dict(attn_impl="pflash:256", fused_ffn=True, fused_vocos=True)}
    tkw = {"tok": dict(attn_impl="pflash", ffn_impl="fused"),
           "detok": dict(attn_impl="pflash", ffn_impl="fused", vocos_impl="fused")}
    _round_trip(params, model, wav, lens, jkw, tkw)


def test_int8_path_f32_matches_jax_kernels(pair):
    """pflash core + fused int8 LN-FFN in every FFN and Vocos chain."""
    params, model = pair
    qparams = dict(params)
    for part in ("encoder", "decoder"):
        qparams[part] = dict(params[part], layers=jq_ffn(params[part]["layers"]))
    qparams["vocos"] = dict(params["vocos"], blocks=jq_convnext(params["vocos"]["blocks"]))
    qmodel = port_model(params)
    quantize_stacked_ffn(qmodel.acoustic_encoder.layers)
    quantize_stacked_ffn(qmodel.acoustic_decoder.layers)
    quantize_stacked_convnext(qmodel.vocos.backbone.convnext)
    np.testing.assert_array_equal(n(qmodel.acoustic_decoder.layers[1].fc2_q),
                                  np.asarray(qparams["decoder"]["layers"]["fc2_q"][1]).T)
    wav, lens = _one_chunk()
    jkw = {"tok": dict(attn_impl="pflash:256", ffn_impl="int8-fused"),
           "detok": dict(attn_impl="pflash:256", ffn_impl="int8-fused", fused_vocos="int8")}
    tkw = {"tok": dict(attn_impl="pflash", ffn_impl="int8-fused"),
           "detok": dict(attn_impl="pflash", ffn_impl="int8-fused", vocos_impl="int8")}
    _round_trip(qparams, qmodel, wav, lens, jkw, tkw)


def test_flash_dw_path_f32_matches_jax_kernels(pair):
    """flash attention core (B5) + fused LN-FFN + whole-block Vocos kernel (B4)."""
    params, model = pair
    wav, lens = _one_chunk()
    jkw = {"tok": dict(attn_impl="flash", fused_ffn=True),
           "detok": dict(attn_impl="flash", fused_ffn=True, fused_vocos="dw")}
    tkw = {"tok": dict(attn_impl="flash", ffn_impl="fused"),
           "detok": dict(attn_impl="flash", ffn_impl="fused", vocos_impl="fused-dw")}
    _round_trip(params, model, wav, lens, jkw, tkw)


def test_fast_int8_codes_equal_fast_codes(utterances):
    """fast-int8 quantises only the decode side, so its codes are fast's."""
    params = jax_params(1)
    fast = tcodec.AudioCodec(TINY, port_model(params), batch_size=2, mode="fast", device="cpu")
    int8 = tcodec.AudioCodec(TINY, port_model(params), batch_size=2, mode="fast-int8", device="cpu")
    short = [u[: 5 * SR] for u in utterances]
    a = fast.encode(short)["codes_list"]
    b = int8.encode(short)["codes_list"]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for w in int8.decode(b)["syn_wav_list"]:
        assert np.isfinite(w).all()


def test_mode_programs():
    tok, detok = tcodec.mode_programs("fast-int8")
    assert tok == {"compute_dtype": "bfloat16", "attn_impl": "pflash", "ffn_impl": "fused"}
    assert detok == {"compute_dtype": "bfloat16", "attn_impl": "pflash", "ffn_impl": "int8-fused",
                     "vocos_impl": "int8"}
    assert tcodec.mode_programs("fast-int8-full")[0]["ffn_impl"] == "int8-fused"
    assert tcodec.mode_programs("fast")[1]["vocos_impl"] == "fused"
    assert tcodec.mode_programs("parity")[1] == {"compute_dtype": "float32", "attn_impl": "dense",
                                                 "ffn_impl": "dense", "vocos_impl": None}
    with pytest.raises(ValueError):
        tcodec.mode_programs("turbo")
    tok, detok = tcodec.mode_programs("fast", attn_impl="flash", vocos_impl="fused-dw")
    assert tok["attn_impl"] == detok["attn_impl"] == "flash" and detok["vocos_impl"] == "fused-dw"
    # the int8 chain wins in the int8 modes
    assert tcodec.mode_programs("fast-int8", vocos_impl="fused-dw")[1]["vocos_impl"] == "int8"
    assert tcodec.mode_programs("parity", attn_impl="flash")[0]["attn_impl"] == "flash"


@pytest.mark.parametrize("mode,kwargs", [
    ("fast", {"attn_impl": "chunked:bf16"}),  # bare "chunked" is a JAX spelling; its block_q must be a number
    ("fast", {"vocos_impl": "dw"}),
    ("fast", {"vocos_impl": "int8"}),
    ("parity", {"vocos_impl": "fused-dw"}),
])
def test_unknown_impls_are_rejected(pair, mode, kwargs):
    with pytest.raises(ValueError):
        tcodec.mode_programs(mode, **kwargs)
    with pytest.raises(ValueError):
        tcodec.AudioCodec(TINY, pair[1], mode=mode, device="cpu", **kwargs)


def test_entry_points_default_to_cuda(pair):
    """No silent CPU: without a GPU the default device raises."""
    if torch.cuda.is_available():
        assert tcodec.resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tcodec.AudioCodec(TINY, pair[1])
    assert tcodec.resolve_device("cpu").type == "cpu"


def test_sub_frame_utterance_and_batch_padding(pair):
    tc = tcodec.AudioCodec(TINY, pair[1], batch_size=4, mode="parity", device="cpu")
    rng = np.random.default_rng(13)
    enc = tc.encode([(rng.standard_normal(400) * 0.1).astype(np.float32),
                     (rng.standard_normal(3000) * 3000).astype(np.int16)])["codes_list"]
    assert enc[0].shape == (8, 0) and enc[1].shape == (8, 2)
    dec = tc.decode(enc)["syn_wav_list"]
    assert dec[0].shape == (0,) and dec[1].shape == (2560,)


@pytest.mark.parametrize("attn_impl", ["pflash", "flash"])
def test_parity_kernel_attention_layer_matches_jax(pair, attn_impl):
    """One f32 encoder layer with the attention kernel's plain version vs the
    JAX layer with its Pallas kernel in interpret mode, within the layer
    tolerance of tests/test_flash_attention.py (2e-5) on the valid rows."""
    params, model = pair
    rng = np.random.default_rng(14)
    x = (rng.standard_normal((2, 200, TINY.acoustic_encoder.d_model)) * 0.3).astype(np.float32)
    lens = np.array([200, 77])
    layer0 = jax.tree.map(lambda a: a[0], params["encoder"]["layers"])
    want = jtransformer.transformer_layer(layer0, jnp.asarray(x), None, TINY.acoustic_encoder.encoder_attention_heads,
                                          precision=HIGHEST, lengths=jnp.asarray(lens), attn_impl=attn_impl)
    with torch.no_grad():
        got = model.acoustic_encoder.layers[0](t(x), None, t(lens), attn_impl)
    for bi, ln in enumerate(lens):
        np.testing.assert_allclose(n(got)[bi, :ln], np.asarray(want)[bi, :ln], atol=2e-5)


@pytest.mark.parametrize("attn_impl", ["pflash", "flash"])
def test_parity_kernel_attention_codec_matches_jax(pair, utterances, attn_impl):
    """AudioCodec(mode="parity", attn_impl=...) in both packages: codes equal,
    waveforms within the parity bound (5e-3)."""
    params, model = pair
    jc = jcodec.AudioCodec(TINY, params, batch_size=2, mode="parity", attn_impl=attn_impl)
    tc = tcodec.AudioCodec(TINY, model, batch_size=2, mode="parity", device="cpu", attn_impl=attn_impl)
    assert tc._tokenize.fn.keywords["attn_impl"] == tc._detokenize.fn.keywords["attn_impl"] == attn_impl
    wavs = [utterances[0], utterances[1][: 23 * SR]]  # one chunk, and two
    jcodes = jc.encode(wavs)["codes_list"]
    tcodes = tc.encode(wavs)["codes_list"]
    for a, b in zip(jcodes, tcodes):
        np.testing.assert_array_equal(b, np.asarray(a))
    for a, b in zip(jc.decode(jcodes)["syn_wav_list"], tc.decode(tcodes)["syn_wav_list"]):
        assert b.shape == np.asarray(a).shape
        assert float(np.abs(b - np.asarray(a)).max()) < 5e-3


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_fast_modes_run_default_precision(pair, precision):
    """As in the JAX package: the fast modes run at "default" precision
    (TF32) whatever the caller asks; parity keeps the caller's."""
    for mode in ("fast", "fast-int8", "fast-int8-full"):
        assert tcodec.AudioCodec(TINY, pair[1], mode=mode, device="cpu", precision=precision).precision == "default"
    assert tcodec.AudioCodec(TINY, pair[1], mode="parity", device="cpu", precision=precision).precision == precision
    assert tcodec.AudioCodec(TINY, pair[1], mode="parity", device="cpu").precision == "highest"


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_f32_precision_flags(precision):
    """Inside the block TF32 is on only for "default"; cuDNN's deterministic
    and benchmark flags keep the caller's values; every flag comes back."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark, cudnn.enabled)
    try:
        for det, bench in ((True, False), (False, True)):
            matmul.allow_tf32, cudnn.allow_tf32 = precision != "default", precision != "default"
            cudnn.deterministic, cudnn.benchmark = det, bench
            before = (matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark, cudnn.enabled)
            with tcodec.f32_precision(precision):
                tf32 = precision == "default"
                assert (matmul.allow_tf32, cudnn.allow_tf32) == (tf32, tf32)
                assert (cudnn.deterministic, cudnn.benchmark) == (det, bench)
            assert (matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark, cudnn.enabled) == before
            with pytest.raises(KeyError):
                with tcodec.f32_precision(precision):
                    raise KeyError("raised inside the block")
            assert (matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark, cudnn.enabled) == before
    finally:
        matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark, cudnn.enabled = saved
