"""The port's code-level checks against the JAX package, on weights whose
codes carry information.

At TINY's raw init every code is the zero level, so a check that codes are
equal passes whatever the encoders compute.  Here the weights are
``informative_params(0)`` (the latent projection x30), and every test first
asserts that each of the 8 code groups takes more than one value in every
utterance it compares.  Then, on the CPU, with the tolerances of the tests
that run the same checks at the raw init:

 - parity codes equal JAX's (6.3 s and 41 s), waveforms within 5e-3;
 - the f32 kernel round trips (pflash + fused LN-FFN, flash + B4, the int8
   FFNs; the JAX kernels in interpret mode): codes equal, waveforms within
   3e-4; parity with the f32 attention kernels: codes equal JAX's;
 - fast-int8 codes equal fast codes; pcm16-wire codes equal the float
   wire's and JAX's; streamed codes equal batch codes and JAX's streamed
   codes; the corpus path's codes equal JAX's; the server's ``/encode``
   answers the codec's codes;
 - the JAX package's agreement floors (tests/test_fast_mode.py), computed by
   the port: fast vs parity > 0.85, fast-int8-full vs parity > 0.85, fast
   with pflash attention vs parity > 0.9.
"""

import http.client
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simwhisper_codec_tpu.eval.corpus import evaluate_corpus as jax_evaluate_corpus
from simwhisper_codec_tpu.models import codec as jcodec
from simwhisper_codec_tpu.models import streaming as jstreaming
from simwhisper_codec_tpu.ops.quant import quantize_stacked_convnext as jq_convnext
from simwhisper_codec_tpu.ops.quant import quantize_stacked_ffn as jq_ffn
from simwhisper_codec_tpu_torch.eval.corpus import evaluate_corpus
from simwhisper_codec_tpu_torch.models import codec as tcodec
from simwhisper_codec_tpu_torch.models.streaming import StreamingEncoder
from simwhisper_codec_tpu_torch.ops.quant import quantize_stacked_convnext, quantize_stacked_ffn
from simwhisper_codec_tpu_torch.serve import CodecHTTPServer, MicroBatcher, make_handler, make_runner
from simwhisper_codec_tpu_torch.utils.audio_io import save_audio
from simwhisper_codec_tpu_torch.utils.flac import write_flac

from torch_port import HIGHEST, TINY, informative_params, n, port_model, t, torch_threads

SR = 16000


def informative(codes) -> None:
    """Each group of a (G, T) code array takes more than one value."""
    codes = np.asarray(codes)
    assert codes.shape[0] == TINY.quantizer.num_groups and codes.shape[-1] > 1, codes.shape
    distinct = [len(np.unique(g)) for g in codes]
    assert min(distinct) > 1, f"a code group holds one value: distinct values per group {distinct}"


def agreement(a, b) -> float:
    return float(np.mean(np.asarray(a) == np.asarray(b)))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Six test workers share the host's cores: two torch threads each."""
    with torch_threads():
        yield


@pytest.fixture(scope="module")
def params():
    return informative_params(0)


@pytest.fixture(scope="module")
def model(params):
    return port_model(params)


@pytest.fixture(scope="module")
def jax_parity(params):
    return jcodec.AudioCodec(TINY, params, batch_size=2, mode="parity")


@pytest.fixture(scope="module")
def parity(model):
    return tcodec.AudioCodec(TINY, model, batch_size=2, mode="parity", device="cpu")


@pytest.fixture(scope="module")
def utterances():
    """The inputs of test_torch_codec.py::test_parity_codec_matches_jax: 6.3 s
    (one short chunk) and 41 s (three chunks, the last one 1 s long)."""
    rng = np.random.default_rng(11)
    return [(rng.standard_normal(k) * 0.1).astype(np.float32) for k in (100800, 41 * SR)]


@pytest.fixture(scope="module")
def jax_codes(jax_parity, utterances):
    codes = [np.asarray(c) for c in jax_parity.encode(utterances)["codes_list"]]
    for c in codes:
        informative(c)
    return codes


def test_parity_codes_match_jax(jax_parity, parity, utterances, jax_codes):
    got = parity.encode(utterances)["codes_list"]
    for w, a, b in zip(utterances, got, jax_codes):
        informative(a)
        assert a.shape == (8, len(w) // 1280) and a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    for a, b in zip(parity.decode(got)["syn_wav_list"], jax_parity.decode(jax_codes)["syn_wav_list"]):
        assert a.shape == np.asarray(b).shape
        assert float(np.abs(a - np.asarray(b)).max()) < 5e-3


def _quantised(params):
    qparams = dict(params)
    for part in ("encoder", "decoder"):
        qparams[part] = dict(params[part], layers=jq_ffn(params[part]["layers"]))
    qparams["vocos"] = dict(params["vocos"], blocks=jq_convnext(params["vocos"]["blocks"]))
    qmodel = port_model(params)
    quantize_stacked_ffn(qmodel.acoustic_encoder.layers)
    quantize_stacked_ffn(qmodel.acoustic_decoder.layers)
    quantize_stacked_convnext(qmodel.vocos.backbone.convnext)
    return qparams, qmodel


ROUND_TRIPS = {
    "pflash-fused": ({"tok": dict(attn_impl="pflash:256", fused_ffn=True),
                      "detok": dict(attn_impl="pflash:256", fused_ffn=True, fused_vocos=True)},
                     {"tok": dict(attn_impl="pflash", ffn_impl="fused"),
                      "detok": dict(attn_impl="pflash", ffn_impl="fused", vocos_impl="fused")}),
    "flash-dw": ({"tok": dict(attn_impl="flash", fused_ffn=True),
                  "detok": dict(attn_impl="flash", fused_ffn=True, fused_vocos="dw")},
                 {"tok": dict(attn_impl="flash", ffn_impl="fused"),
                  "detok": dict(attn_impl="flash", ffn_impl="fused", vocos_impl="fused-dw")}),
    "int8": ({"tok": dict(attn_impl="pflash:256", ffn_impl="int8-fused"),
              "detok": dict(attn_impl="pflash:256", ffn_impl="int8-fused", fused_vocos="int8")},
             {"tok": dict(attn_impl="pflash", ffn_impl="int8-fused"),
              "detok": dict(attn_impl="pflash", ffn_impl="int8-fused", vocos_impl="int8")}),
}


@pytest.mark.parametrize("name", list(ROUND_TRIPS))
def test_f32_kernel_round_trips_match_jax(params, model, name):
    """test_torch_codec.py's round trips (3 s in one chunk, f32; the JAX
    kernels in Pallas interpret mode) on informative weights."""
    jkw, tkw = ROUND_TRIPS[name]
    if name == "int8":
        params, model = _quantised(params)
    rng = np.random.default_rng(12)
    wav = np.zeros((1, TINY.chunk_samples), np.float32)
    k = 3 * SR
    wav[0, :k] = rng.standard_normal(k) * 0.1
    lens = np.array([k])
    consts = jcodec.CodecConstants(TINY)
    jtok = jcodec.tokenize(TINY, consts, params, jnp.asarray(wav), jnp.asarray(lens), precision=HIGHEST, **jkw["tok"])
    codes, clen = np.asarray(jtok["codes"]), np.asarray(jtok["codes_lengths"])
    width = int(clen.max())
    informative(codes[:, 0, :width])
    with torch.no_grad():
        ttok = tcodec.tokenize(model, t(wav), t(lens), **tkw["tok"])
    np.testing.assert_array_equal(n(ttok["codes"]), codes)
    jdet = jcodec.detokenize(TINY, consts, params, jnp.asarray(codes), jnp.asarray(clen), jnp.int32(width),
                             precision=HIGHEST, **jkw["detok"])
    with torch.no_grad():
        tdet = tcodec.detokenize(model, t(codes), t(clen), width, **tkw["detok"])
    keep = width * 1280
    np.testing.assert_allclose(n(tdet["y"])[:, :keep], np.asarray(jdet["y"])[:, :keep], atol=3e-4)


@pytest.mark.parametrize("attn_impl", ["pflash", "flash"])
def test_parity_kernel_attention_codes_match_jax(params, model, utterances, attn_impl):
    """Parity with the f32 attention kernels (plain versions here; JAX in
    interpret mode): codes equal, waveforms within 5e-3."""
    wavs = [utterances[0], utterances[1][: 23 * SR]]  # one chunk, and two
    jc = jcodec.AudioCodec(TINY, params, batch_size=2, mode="parity", attn_impl=attn_impl)
    tc = tcodec.AudioCodec(TINY, model, batch_size=2, mode="parity", device="cpu", attn_impl=attn_impl)
    jcodes = jc.encode(wavs)["codes_list"]
    tcodes = tc.encode(wavs)["codes_list"]
    for a, b in zip(tcodes, jcodes):
        informative(a)
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(tc.decode(tcodes)["syn_wav_list"], jc.decode(jcodes)["syn_wav_list"]):
        assert float(np.abs(a - np.asarray(b)).max()) < 5e-3


def test_fast_int8_codes_equal_fast_codes(model, utterances):
    fast = tcodec.AudioCodec(TINY, model, batch_size=2, mode="fast", device="cpu")
    int8 = tcodec.AudioCodec(TINY, port_model(informative_params(0)), batch_size=2, mode="fast-int8", device="cpu")
    short = [u[: 5 * SR] for u in utterances]
    a = fast.encode(short)["codes_list"]
    b = int8.encode(short)["codes_list"]
    for x, y in zip(a, b):
        informative(x)
        np.testing.assert_array_equal(x, y)
    for w in int8.decode(b)["syn_wav_list"]:
        assert np.isfinite(w).all()


def test_pcm16_codes_match_float_wire_and_jax(params, model, parity):
    rng = np.random.default_rng(0)
    wavs = [rng.integers(-20000, 20000, k).astype(np.float32) / 32768.0 for k in (16000, 9000)]
    pcm = tcodec.AudioCodec(TINY, model, batch_size=2, mode="parity", device="cpu", wire="pcm16")
    got = pcm.encode(wavs)["codes_list"]
    want = jcodec.AudioCodec(TINY, params, batch_size=2, mode="parity", wire="pcm16").encode(wavs)["codes_list"]
    for a, b, c in zip(got, want, parity.encode(wavs)["codes_list"]):
        informative(a)
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, c)


def _stream_codes(enc, wav, block):
    chunks = [out for start in range(0, len(wav), block)
              if (out := enc.feed(wav[start:start + block])) is not None]
    tail = enc.flush()
    return np.concatenate(chunks + ([tail] if tail is not None else []), axis=1)


def test_streamed_codes_match_batch_and_jax(jax_parity, parity):
    """As test_torch_streaming.py: 47 s (two strides and a tail) streamed in
    odd blocks against the batch codes, and 33 s streamed by both packages."""
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal(47 * SR) * 0.1).astype(np.float32)
    batch = parity.encode([wav], overlap_seconds=10)["codes_list"][0]
    informative(batch)
    np.testing.assert_array_equal(_stream_codes(StreamingEncoder(parity, overlap_seconds=10), wav, 12345), batch)
    wav = (rng.standard_normal(33 * SR) * 0.1).astype(np.float32)
    want = np.asarray(_stream_codes(jstreaming.StreamingEncoder(jax_parity, overlap_seconds=10), wav, 16000))
    got = _stream_codes(StreamingEncoder(parity, overlap_seconds=10), wav, 16000)
    informative(got)
    np.testing.assert_array_equal(got, want)


class _Recorder:
    """Wraps a codec's ``encode`` to keep every batch's codes."""

    def __init__(self, codec):
        self.codes, self._encode = [], codec.encode
        codec.encode = self

    def __call__(self, *args, **kwargs):
        out = self._encode(*args, **kwargs)
        self.codes += [np.asarray(c) for c in out["codes_list"]]
        return out


def test_corpus_codes_match_jax(tmp_path, params, model):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    rng = np.random.default_rng(0)
    for name, k in {"u0.flac": 48000, "u1.flac": 36000, "w0.wav": 27000, "w1.wav": 69000}.items():
        wav = (rng.standard_normal(k) * 0.1).astype(np.float32)
        if name.endswith(".flac"):
            write_flac(corpus / name, np.round(wav * 32767).astype(np.int64), 16000)
        else:
            save_audio(corpus / name, wav)
    tc = tcodec.AudioCodec(TINY, model, batch_size=2, mode="parity", device="cpu")
    jc = jcodec.AudioCodec(TINY, params, batch_size=2, mode="parity")
    got, want = _Recorder(tc), _Recorder(jc)
    a = evaluate_corpus(tc, str(corpus), str(tmp_path / "port"), batch_size=2)
    b = jax_evaluate_corpus(jc, str(corpus), str(tmp_path / "jax"), batch_size=2)
    assert a["files"] == b["files"] == 4 and a["num_batches"] == b["num_batches"]
    assert len(got.codes) == len(want.codes) == 4
    for x, y in zip(got.codes, want.codes):
        informative(x)
        np.testing.assert_array_equal(x, y)


def test_server_encode_answers_the_codecs_codes(parity):
    server = CodecHTTPServer(("127.0.0.1", 0), make_handler(MicroBatcher(make_runner(parity), max_batch=2), 16000))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        wav = (np.random.default_rng(0).standard_normal(32000) * 0.1).astype(np.float32)
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
        try:
            conn.request("POST", "/encode", body=wav.tobytes())
            resp = conn.getresponse()
            status, shape, raw = resp.status, resp.getheader("X-Code-Shape"), resp.read()
        finally:
            conn.close()
        assert status == 200 and shape == "8,25"
        codes = np.frombuffer(raw, np.int32).reshape(8, 25)
        informative(codes)
        np.testing.assert_array_equal(codes, parity.encode([wav])["codes_list"][0])
    finally:
        server.shutdown()
        server.server_close()


# The JAX package's agreement floors (tests/test_fast_mode.py:33,91,114), on
# the port's codecs and those tests' inputs.
FLOORS = {
    "fast": ({"mode": "fast"}, 0, 48000, 0.85),
    "fast-int8-full": ({"mode": "fast-int8-full"}, 1, 32000, 0.85),
    "pflash": ({"mode": "fast", "attn_impl": "pflash"}, 2, 24000, 0.9),
}


@pytest.mark.parametrize("name", list(FLOORS))
def test_agreement_with_parity_above_the_jax_floor(model, parity, name):
    kwargs, seed, k, floor = FLOORS[name]
    wavs = [(np.random.default_rng(seed).standard_normal(k) * 0.1).astype(np.float32)]
    want = parity.encode(wavs, overlap_seconds=10)["codes_list"][0]
    informative(want)
    got = tcodec.AudioCodec(TINY, model, device="cpu", **kwargs).encode(wavs, overlap_seconds=10)["codes_list"][0]
    assert got.shape == want.shape
    share = agreement(got, want)
    assert share > floor, f"{name} code agreement with parity {share:.3f} <= {floor}"
