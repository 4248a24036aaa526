"""The port's streaming sessions on the CPU at TINY, mirroring
tests/test_streaming.py: streamed codes equal the port's batch codes
exactly, streamed waveforms equal its batch decode within 1e-6, the
``stream_encode`` generator agrees, and the port's streamed parity codes
equal the JAX package's streamed codes on the same weights."""

import numpy as np
import pytest

from simwhisper_codec_tpu.models import codec as jcodec
from simwhisper_codec_tpu.models import streaming as jstreaming
from simwhisper_codec_tpu_torch.models import codec as tcodec
from simwhisper_codec_tpu_torch.models.streaming import StreamingDecoder, StreamingEncoder, stream_encode

from torch_port import TINY, jax_params, port_model

SR = 16000


@pytest.fixture(scope="module")
def pair():
    params = jax_params(0)
    return params, tcodec.AudioCodec(TINY, port_model(params), batch_size=2, mode="parity", device="cpu")


def _wav(seed, seconds):
    return (np.random.default_rng(seed).standard_normal(int(seconds * SR)) * 0.1).astype(np.float32)


def _stream_codes(enc, wav, block):
    chunks = [out for start in range(0, len(wav), block)
              if (out := enc.feed(wav[start:start + block])) is not None]
    tail = enc.flush()
    return np.concatenate(chunks + ([tail] if tail is not None else []), axis=1)


def test_streaming_encoder_matches_batch(pair):
    _, codec = pair
    wav = _wav(0, 47)  # two strides and a tail
    batch = codec.encode([wav], overlap_seconds=10)["codes_list"][0]
    streamed = _stream_codes(StreamingEncoder(codec, overlap_seconds=10), wav, 12345)  # odd block size
    assert streamed.shape == batch.shape == (8, len(wav) // 1280)
    np.testing.assert_array_equal(streamed, batch)


def test_streaming_decoder_matches_batch(pair):
    _, codec = pair
    codes = codec.encode([_wav(1, 41)], overlap_seconds=10)["codes_list"][0]
    batch = codec.decode([codes], overlap_seconds=10)["syn_wav_list"][0]
    dec = StreamingDecoder(codec, overlap_seconds=10)
    outs = [out for start in range(0, codes.shape[1], 37) if (out := dec.feed(codes[:, start:start + 37])) is not None]
    tail = dec.flush()
    streamed = np.concatenate(outs + ([tail] if tail is not None else []))
    assert streamed.shape == batch.shape and streamed.dtype == np.float32
    np.testing.assert_allclose(streamed, batch, atol=1e-6)


def test_stream_encode_generator(pair):
    _, codec = pair
    wav = _wav(2, 35)
    streamed = np.concatenate(list(stream_encode(codec, (wav[i:i + SR] for i in range(0, len(wav), SR)))), axis=1)
    np.testing.assert_array_equal(streamed, codec.encode([wav], overlap_seconds=10)["codes_list"][0])


def test_streamed_parity_codes_match_jax(pair):
    params, codec = pair
    wav = _wav(3, 33)
    jc = jcodec.AudioCodec(TINY, params, batch_size=2, mode="parity")
    want = _stream_codes(jstreaming.StreamingEncoder(jc, overlap_seconds=10), wav, 16000)
    got = _stream_codes(StreamingEncoder(codec, overlap_seconds=10), wav, 16000)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
