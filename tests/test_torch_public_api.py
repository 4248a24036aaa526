"""The last public functions of the JAX package with a twin in the port, each
against the JAX function on the CPU:

 - ``load_codec`` (package level): the same ``.pt`` through both packages'
   ``load_codec`` encodes to the same codes (``informative_params``, so the
   codes span the FSQ levels);
 - ``ops/mel.py``: ``zero_mean_unit_var_norm`` within 1e-6;
   ``log_mel_dithered`` equal to the JAX ``log_mel`` of ``wav + dither *
   noise`` with the port's noise handed over, and to ``log_mel`` at
   ``dither = 0`` (mel tolerance 5e-5, PARITY.md);
 - ``ops/fsq.py``: ``group_fsq_encode`` and ``codebook_size`` equal;
 - ``utils/native_loader.py``: ``save_audio`` / ``load_audio`` round-trip a
   WAV to the JAX loader's samples, through the native library and through
   the Python fallback of each package.
"""

from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import simwhisper_codec_tpu
import simwhisper_codec_tpu_torch
from simwhisper_codec_tpu.ops import fsq as jfsq
from simwhisper_codec_tpu.ops import mel as jmel
from simwhisper_codec_tpu.utils import native_loader as jnl
from simwhisper_codec_tpu_torch.config import CodecConfig
from simwhisper_codec_tpu_torch.ops import fsq as tfsq
from simwhisper_codec_tpu_torch.ops import mel as tmel
from simwhisper_codec_tpu_torch.utils import native_loader as tnl

from test_codec_e2e import GENERATOR_PARAMS
from torch_port import HIGHEST, TINY, informative_params, n, port_model, t

SR = 16000


def test_load_codec_serves_the_jax_codes(tmp_path):
    cfg = tmp_path / "tiny.yaml"
    params = dict(GENERATOR_PARAMS, vocos=dict(GENERATOR_PARAMS["vocos"], num_layers=TINY.vocos.num_layers),
                  acoustic_encoder=dict(GENERATOR_PARAMS["acoustic_encoder"], freeze=TINY.acoustic_encoder.freeze))
    cfg.write_text(yaml.safe_dump({"generator_params": params}))
    pt = tmp_path / "codec.pt"
    torch.save({"model": port_model(informative_params(0)).state_dict()}, pt)
    tc = simwhisper_codec_tpu_torch.load_codec(str(cfg), str(pt), batch_size=1, mode="parity", device="cpu")
    jc = simwhisper_codec_tpu.load_codec(str(cfg), str(pt), batch_size=1, mode="parity")
    assert (tc.mode, tc.batch_size, tc.device.type) == ("parity", 1, "cpu")
    assert asdict(tc.cfg) == asdict(CodecConfig.from_dict(params))
    wav = (np.random.default_rng(12).standard_normal(3 * SR) * 0.1).astype(np.float32)
    (got,), (want,) = tc.encode([wav])["codes_list"], jc.encode([wav])["codes_list"]
    assert all(len(np.unique(group)) > 1 for group in got), "codes carry no information"
    np.testing.assert_array_equal(got, np.asarray(want))


def test_zero_mean_unit_var_norm_matches():
    rng = np.random.default_rng(13)
    wav = (rng.standard_normal((4, 1000)) * 0.3 + 0.05).astype(np.float32)
    lens = np.array([1000, 417, 1, 0])
    want = jmel.zero_mean_unit_var_norm(jnp.asarray(wav), jnp.asarray(lens), padding_value=-1.5)
    got = tmel.zero_mean_unit_var_norm(t(wav), t(lens), padding_value=-1.5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), atol=1e-6, rtol=0)
    assert (n(got)[1, 417:] == -1.5).all() and (n(got)[3] == -1.5).all()


@pytest.mark.parametrize("dither", [0.0, 1e-3])
def test_log_mel_dithered_matches(dither):
    cfg = TINY.feature_extractor
    wav = (np.random.default_rng(14).standard_normal((2, cfg.n_samples)) * 0.1).astype(np.float32)
    consts = tmel.MelConstants(cfg)
    got = tmel.log_mel_dithered(consts, t(wav), torch.Generator().manual_seed(5), dither)
    noise = torch.randn(wav.shape, generator=torch.Generator().manual_seed(5)).numpy()  # the port's draw
    jconsts = jmel.make_constants(cfg)
    want = jmel.log_mel(jconsts, jnp.asarray(wav + np.float32(dither) * noise), precision=HIGHEST)
    np.testing.assert_allclose(n(got), n(want), atol=5e-5)
    if dither == 0.0:
        np.testing.assert_array_equal(n(got), n(tmel.log_mel(consts, t(wav))))
        np.testing.assert_allclose(n(got), n(jmel.log_mel_dithered(jconsts, jnp.asarray(wav), None, 0.0,
                                                                   precision=HIGHEST)), atol=5e-5)
    else:
        assert not torch.equal(got, tmel.log_mel(consts, t(wav)))  # the noise was added


def test_group_fsq_encode_and_codebook_size_match():
    rng = np.random.default_rng(15)
    x = (rng.standard_normal((3, 40, 32)) * 2).astype(np.float32)
    lens = np.array([40, 9, 0])
    jc, tc = jfsq.make_constants(TINY.quantizer), tfsq.FSQConstants(TINY.quantizer)
    for lengths in (None, lens):
        want = jfsq.group_fsq_encode(jc, jnp.asarray(x), None if lengths is None else jnp.asarray(lengths))
        got = tfsq.group_fsq_encode(tc, t(x), None if lengths is None else t(lengths))
        assert got.dtype == torch.int32 and got.shape == (8, 3, 40)
        np.testing.assert_array_equal(n(got), n(want))
    assert tfsq.codebook_size(CodecConfig().quantizer) == jfsq.codebook_size(TINY.quantizer) == 2016 ** 8


@pytest.mark.parametrize("native", [True, False])
def test_save_and_load_audio_round_trip(tmp_path, monkeypatch, native):
    """A float WAV (with clipped samples) written by the port's ``save_audio``
    and read by its ``load_audio``, at the file's rate and resampled, equals
    what the JAX loader reads from the file; the JAX ``save_audio`` writes
    the same bytes."""
    if native:
        assert tnl.available() and jnl.available()
    else:
        monkeypatch.setattr(tnl, "get_lib", lambda: None)
        monkeypatch.setattr(jnl, "get_lib", lambda: None)
    rng = np.random.default_rng(16)
    wav = np.clip(rng.standard_normal(SR // 2) * 0.3, -1.2, 1.2).astype(np.float32)
    path, jpath = tmp_path / "port.wav", tmp_path / "jax.wav"
    tnl.save_audio(str(path), wav)
    jnl.save_audio(str(jpath), wav)
    assert path.read_bytes() == jpath.read_bytes()
    before = dict(tnl.loaded_files)
    for rate in (SR, 24000):
        got = tnl.load_audio(str(path), rate)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jnl.load_audio(str(path), rate))
    assert tnl.loaded_files["native" if native else "python"] - before["native" if native else "python"] == 2
    at_rate = tnl.load_audio(str(path), SR)
    np.testing.assert_allclose(at_rate, np.clip(wav, -1.0, 32767 / 32768), atol=1 / 32768)
