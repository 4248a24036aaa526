"""The port's host audio path against the JAX package's, on the CPU: the FLAC
codec (decode, encode bytes, CRCs, probe), MP3 through the system
libraries, ``load_audio`` / ``probe_audio_length``, the native batch loader
(native and Python paths, mixed formats, per-file skips), and the corpus
batching helpers of ``utils/data.py``."""

import numpy as np
import pytest

from simwhisper_codec_tpu.utils import audio_io as jio
from simwhisper_codec_tpu.utils import data as jdata
from simwhisper_codec_tpu.utils import flac as jflac
from simwhisper_codec_tpu.utils import mp3 as jmp3
from simwhisper_codec_tpu.utils import native_loader as jnl
from simwhisper_codec_tpu_torch.utils import audio_io as tio
from simwhisper_codec_tpu_torch.utils import data as tdata
from simwhisper_codec_tpu_torch.utils import flac as tflac
from simwhisper_codec_tpu_torch.utils import mp3 as tmp3
from simwhisper_codec_tpu_torch.utils import native_loader as tnl

FLAC_VARIANTS = [
    ({}, 1),                                   # fixed-order subframes
    ({"force_verbatim": True}, 1),
    ({"use_lpc": True, "lpc_order": 8}, 1),
    ({"use_lpc": True, "lpc_order": 32}, 1),
    ({"block_size": 192}, 1),                  # many frames, a partial last one
    ({"stereo_mode": "independent"}, 2),
    ({"stereo_mode": "left_side"}, 2),
    ({"stereo_mode": "right_side"}, 2),
    ({"stereo_mode": "mid_side"}, 2),
]


def speechlike(seed, n=6000, sr=16000, amp=8000):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    sig = (amp * np.sin(2 * np.pi * 220 * t / sr) + amp * 0.3 * np.sin(2 * np.pi * 520 * t / sr)
           + 100 * rng.standard_normal(n))
    return np.clip(sig, -32768, 32767).astype(np.int64)


def _pcm(seed, channels):
    left = speechlike(seed)
    if channels == 1:
        return left
    return np.stack([left, np.clip((left * 0.7).astype(np.int64) + speechlike(seed + 1) // 8, -32768, 32767)], axis=1)


@pytest.fixture
def mp3_libs():
    """MP3 cases need the system libmpg123 and libmp3lame (the condition of tests/test_mp3.py)."""
    if not (jmp3.have_mpg123() and jmp3.have_lame()):
        pytest.skip("system libmpg123/libmp3lame unavailable")


@pytest.mark.parametrize("kw,channels", FLAC_VARIANTS)
def test_flac_encode_and_decode_equal_jax(kw, channels, tmp_path):
    pcm = _pcm(7, channels)
    blob = tflac.encode_flac(pcm, 16000, **kw)
    assert blob == jflac.encode_flac(pcm, 16000, **kw)
    out, rate = tflac.decode_flac(blob)
    np.testing.assert_array_equal(out, jflac.decode_flac(blob)[0])
    np.testing.assert_array_equal(out, pcm.reshape(len(pcm), -1).astype(np.float32) / 32768.0)
    assert rate == 16000
    # files written by either package decode to the same arrays in both
    tflac.write_flac(tmp_path / "t.flac", pcm, 22050, **kw)
    jflac.write_flac(tmp_path / "j.flac", pcm, 22050, **kw)
    for name in ("t.flac", "j.flac"):
        np.testing.assert_array_equal(tflac.read_flac(tmp_path / name)[0], jflac.read_flac(tmp_path / name)[0])
        np.testing.assert_array_equal(tio.load_audio(tmp_path / name), jio.load_audio(tmp_path / name))


def test_flac_crc_and_truncation_raise():
    blob = bytearray(tflac.encode_flac(speechlike(1, 2000), 16000))
    blob[len(blob) // 2] ^= 0x40  # a bit flipped mid-frame
    with pytest.raises(tflac.FlacError, match="CRC"):
        tflac.decode_flac(bytes(blob))
    good = tflac.encode_flac(speechlike(1, 2000), 16000)
    for cut in (b"fLaC", good[:20], good[:-5]):
        with pytest.raises(tflac.FlacError):
            tflac.decode_flac(cut)
        with pytest.raises(jflac.FlacError):
            jflac.decode_flac(cut)


def test_trailing_junk_is_tolerated():
    sig = speechlike(2, 5000)
    junk = tflac.encode_flac(sig, 16000) + b"TAG" + bytes(125)  # an ID3v1 block
    np.testing.assert_array_equal(tflac.decode_flac(junk)[0][:, 0], sig.astype(np.float32) / 32768.0)


def test_probes_equal_jax(tmp_path):
    sig = speechlike(3, 12345)
    tflac.write_flac(tmp_path / "x.flac", sig, 22050)
    tio.save_audio(tmp_path / "y.wav", sig.astype(np.float32) / 32768.0, 24000)
    info = tflac.probe_flac(str(tmp_path / "x.flac"))
    assert info == jflac.probe_flac(str(tmp_path / "x.flac")) == {"sample_rate": 22050, "channels": 1, "bps": 16,
                                                                 "total_samples": 12345}
    for name in ("x.flac", "y.wav"):
        n = tio.probe_audio_length(tmp_path / name, 16000)
        assert n == jio.probe_audio_length(tmp_path / name, 16000) == len(tio.load_audio(tmp_path / name, 16000))


def test_mp3_decode_probe_and_load_equal_jax(mp3_libs, tmp_path):
    t = np.arange(32000) / 16000
    tone = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    tmp3.write_mp3(tmp_path / "t.mp3", tone, 16000)
    jmp3.write_mp3(tmp_path / "j.mp3", np.stack([tone, -tone], axis=1), 32000)
    assert (tmp_path / "t.mp3").stat().st_size > 0
    for name in ("t.mp3", "j.mp3"):
        got, rate = tmp3.read_mp3(tmp_path / name)
        want, want_rate = jmp3.read_mp3(tmp_path / name)
        np.testing.assert_array_equal(got, want)
        assert rate == want_rate and tmp3.probe_mp3(tmp_path / name) == jmp3.probe_mp3(tmp_path / name)
        np.testing.assert_array_equal(tio.load_audio(tmp_path / name), jio.load_audio(tmp_path / name))
        assert tio.probe_audio_length(tmp_path / name) == jio.probe_audio_length(tmp_path / name)
    assert len(tmp3.read_mp3(tmp_path / "t.mp3")[0]) == len(tone)  # gapless: the LAME tag trims delay and padding
    (tmp_path / "bad.mp3").write_bytes(b"\x00" * 64)
    with pytest.raises(RuntimeError):
        tmp3.read_mp3(tmp_path / "bad.mp3")


def test_load_audio_errors_name_the_decoder(tmp_path):
    (tmp_path / "x.flac").write_bytes(b"fLaC")
    with pytest.raises(RuntimeError, match="truncated metadata") as err:
        tio.load_audio(tmp_path / "x.flac")
    assert isinstance(err.value.__cause__, tflac.FlacError)
    (tmp_path / "x.ogg").write_bytes(b"OggS")
    with pytest.raises(RuntimeError, match="no native decoder"):
        tio.load_audio(tmp_path / "x.ogg")


@pytest.fixture
def mixed_corpus(tmp_path):
    """WAV (16 and 22.05 kHz), FLAC (mono, stereo), a corrupt WAV and a
    corrupt FLAC, and an MP3 where the system libraries exist."""
    rng = np.random.default_rng(4)
    tio.save_audio(tmp_path / "a.wav", (rng.standard_normal(9000) * 0.2).astype(np.float32))
    tio.save_audio(tmp_path / "b.wav", (rng.standard_normal(7000) * 0.2).astype(np.float32), 22050)
    tflac.write_flac(tmp_path / "c.flac", speechlike(5, 8000), 16000)
    tflac.write_flac(tmp_path / "d.flac", _pcm(6, 2), 22050, stereo_mode="mid_side")
    (tmp_path / "e.wav").write_bytes(b"RIFFgarbage")
    (tmp_path / "f.flac").write_bytes(tflac.encode_flac(speechlike(7, 3000), 16000)[:-40])
    paths = [str(tmp_path / n) for n in ("a.wav", "b.wav", "c.flac", "d.flac", "e.wav", "f.flac")]
    if tmp3.have_mpg123() and tmp3.have_lame():
        tmp3.write_mp3(tmp_path / "g.mp3", (rng.standard_normal(16000) * 0.2).astype(np.float32), 16000)
        paths.append(str(tmp_path / "g.mp3"))
    return paths


def test_load_audio_batch_equals_jax(mixed_corpus):
    assert tnl.available() and jnl.available()
    before = dict(tnl.loaded_files)
    got = tnl.load_audio_batch(mixed_corpus, 16000, num_threads=3, on_error="none")
    want = jnl.load_audio_batch(mixed_corpus, 16000, num_threads=3, on_error="none")
    assert [g is None for g in got] == [w is None for w in want]
    assert [p.rsplit("/", 1)[1] for p, g in zip(mixed_corpus, got) if g is None] == ["e.wav", "f.flac"]
    for g, w in zip(got, want):
        if g is not None:
            np.testing.assert_array_equal(g, w)
    native = sum(p.endswith((".wav", ".flac")) for p in mixed_corpus) - 2
    assert tnl.loaded_files["native"] - before["native"] == native
    assert tnl.loaded_files["python"] - before["python"] == len(mixed_corpus) - 2 - native
    with pytest.raises(Exception):
        tnl.load_audio_batch(mixed_corpus, 16000, on_error="raise")


def test_native_and_python_paths_agree(mixed_corpus):
    """The C++ decoders and resampler against the port's Python path."""
    good = [p for p in mixed_corpus if not p.endswith(("e.wav", "f.flac"))]
    for p, wav in zip(good, tnl.load_audio_batch(good, 16000)):
        np.testing.assert_allclose(wav, tio.load_audio(p, 16000), atol=1e-6)
    assert tnl.library_path().parent == tnl.BUILD_DIR and tnl.library_path().exists()


def test_corpus_batching_helpers_equal_jax():
    lengths = [int(v) for v in np.random.default_rng(8).integers(100, 100000, 23)]
    for bs in (1, 4, 8):
        assert tdata.length_bucket_batches(lengths, bs) == jdata.length_bucket_batches(lengths, bs)
        assert tdata.length_bucket_batches(lengths, bs, order="given") == \
            jdata.length_bucket_batches(lengths, bs, order="given")
    files = [f"f{i}.wav" for i in range(11)]
    for rank in range(3):
        assert tdata.shard_files_by_process(files, rank, 3) == jdata.shard_files_by_process(files, rank, 3)
    weights = np.random.default_rng(9).random(17)
    for rank in range(4):
        ts = tdata.DistributedWeightedSampler(weights, 50, 4, rank, seed=3)
        js = jdata.DistributedWeightedSampler(weights, 50, 4, rank, seed=3)
        for epoch in (0, 2):
            ts.set_epoch(epoch)
            js.set_epoch(epoch)
            assert list(ts) == list(js) and len(ts) == len(js)
    with pytest.raises(ValueError):
        tdata.DistributedWeightedSampler(weights, 5, 2, 2)


def test_manifests_round_trip(tmp_path):
    records = [{"wav": "a.wav", "duration": 1.5}, {"wav": "b.flac", "duration": 30.0}, {"wav": "c.mp3"}]
    tdata.write_jsonl_manifest(tmp_path / "m.jsonl", records)
    assert tdata.read_jsonl_manifest(tmp_path / "m.jsonl") == jdata.read_jsonl_manifest(tmp_path / "m.jsonl") == records
    for lo, hi in ((None, None), (1.0, 10.0), (2.0, None)):
        assert tdata.filter_manifest(records, lo, hi) == jdata.filter_manifest(records, lo, hi)
