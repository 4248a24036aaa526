"""The port's PCM16 wire and its WAV I/O, on the CPU at TINY, mirroring
tests/test_wire.py: codes on the int16 wire equal the JAX package's on the
same wire and the port's on the float wire (for input on the 16-bit grid);
the int16 decode equals the float decode quantised on the host."""

import numpy as np
import pytest

from simwhisper_codec_tpu.models import codec as jcodec
from simwhisper_codec_tpu.utils.audio_io import resample as jresample
from simwhisper_codec_tpu_torch.models import codec as tcodec
from simwhisper_codec_tpu_torch.utils.audio_io import find_audio_files, load_audio, resample, save_audio, to_pcm16
from simwhisper_codec_tpu_torch.utils.flac import FlacError

from torch_port import TINY, jax_params, port_model


@pytest.fixture(scope="module")
def codecs():
    params = jax_params(0)
    model = port_model(params)
    f32 = tcodec.AudioCodec(TINY, model, batch_size=2, mode="parity", device="cpu")
    pcm = tcodec.AudioCodec(TINY, model, batch_size=2, mode="parity", device="cpu", wire="pcm16")
    return params, f32, pcm


def _grid_wavs(rng, lengths):
    """Waveforms exactly on the int16 / 32768 grid (decoded 16-bit PCM)."""
    return [rng.integers(-20000, 20000, k).astype(np.float32) / 32768.0 for k in lengths]


def test_pcm16_codes_match_jax_and_float_wire(codecs):
    params, f32, pcm = codecs
    wavs = _grid_wavs(np.random.default_rng(0), [16000, 9000])
    got = pcm.encode(wavs)["codes_list"]
    want = jcodec.AudioCodec(TINY, params, batch_size=2, mode="parity", wire="pcm16").encode(wavs)["codes_list"]
    for a, b, c in zip(got, want, f32.encode(wavs)["codes_list"]):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, c)


def test_int16_and_mixed_dtype_batches(codecs):
    _, f32, _ = codecs
    rng = np.random.default_rng(1)
    ints = rng.integers(-20000, 20000, 12000).astype(np.int16)
    flt = rng.integers(-20000, 20000, 9000).astype(np.float32) / 32768.0
    as_float = ints.astype(np.float32) / 32768.0
    np.testing.assert_array_equal(f32.encode([ints])["codes_list"][0], f32.encode([as_float])["codes_list"][0])
    for a, b in zip(f32.encode([ints, flt])["codes_list"], f32.encode([as_float, flt])["codes_list"]):
        np.testing.assert_array_equal(a, b)


def test_pcm16_decode_is_the_host_quantised_float_decode(codecs):
    _, f32, pcm = codecs
    codes = f32.encode(_grid_wavs(np.random.default_rng(2), [14000, 41 * 16000]))["codes_list"]
    for y_f32, y_pcm in zip(f32.decode(codes)["syn_wav_list"], pcm.decode(codes)["syn_wav_list"]):
        assert y_pcm.dtype == np.int16 and y_pcm.shape == y_f32.shape
        np.testing.assert_array_equal(y_pcm, to_pcm16(y_f32))


def test_unknown_wire_and_precision_raise(codecs):
    model = codecs[1].model
    with pytest.raises(ValueError, match="wire"):
        tcodec.AudioCodec(TINY, model, device="cpu", wire="int8")
    with pytest.raises(ValueError, match="precision"):
        tcodec.AudioCodec(TINY, model, device="cpu", precision="high")


def test_save_load_audio(tmp_path):
    rng = np.random.default_rng(3)
    y = (rng.standard_normal(5000) * 0.2).astype(np.float32)
    save_audio(tmp_path / "f.wav", y)
    save_audio(tmp_path / "i.wav", to_pcm16(y))
    assert (tmp_path / "f.wav").read_bytes() == (tmp_path / "i.wav").read_bytes()
    np.testing.assert_array_equal(load_audio(tmp_path / "i.wav"), to_pcm16(y).astype(np.float32) / 32768.0)
    assert len(load_audio(tmp_path / "i.wav", target_sample_rate=24000)) == 7500
    (tmp_path / "x.flac").write_bytes(b"fLaC")
    assert find_audio_files(str(tmp_path)) == sorted(str(tmp_path / f) for f in ("f.wav", "i.wav", "x.flac"))
    # a truncated FLAC stream raises the FLAC decoder's own error
    with pytest.raises(RuntimeError, match="truncated metadata") as err:
        load_audio(tmp_path / "x.flac")
    assert isinstance(err.value.__cause__, FlacError)


@pytest.mark.parametrize("orig_sr", [8000, 44100])
def test_resample_is_the_jax_packages(orig_sr):
    x = np.random.default_rng(4).standard_normal(3001).astype(np.float32)
    np.testing.assert_array_equal(resample(x, orig_sr, 16000), jresample(x, orig_sr, 16000))
