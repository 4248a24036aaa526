"""Each module of the PyTorch port vs its JAX counterpart, on the CPU at TINY.

Same weights (one JAX init tree through ``params_from_jax``) and the same
numpy inputs go through both packages.  Tolerances are the JAX package's own
(PARITY.md): mel <= 5e-5, FSQ indices exact, snake <= 1e-5, transformer
stacks <= 5e-5, samplers <= 2e-5, Vocos <= 3e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simwhisper_codec_tpu.models import sampling as jsampling
from simwhisper_codec_tpu.models import transformer as jtransformer
from simwhisper_codec_tpu.models import vocos as jvocos
from simwhisper_codec_tpu.ops import conv as jconv
from simwhisper_codec_tpu.ops import fsq as jfsq
from simwhisper_codec_tpu.ops import mel as jmel
from simwhisper_codec_tpu.ops import snake as jsnake
from simwhisper_codec_tpu_torch import config as tconfig
from simwhisper_codec_tpu_torch.ops import conv as tconv
from simwhisper_codec_tpu_torch.ops import fsq as tfsq
from simwhisper_codec_tpu_torch.ops import mel as tmel
from simwhisper_codec_tpu_torch.ops import snake as tsnake

from conftest import REPO_ROOT
from torch_port import HIGHEST, TINY, jax_params, n, port_model, t


@pytest.fixture(scope="module")
def pair():
    params = jax_params(0)
    return params, port_model(params)


def test_config_reads_the_repo_yaml():
    cfg = tconfig.load_config(str(REPO_ROOT / "config" / "SimWhisperCodec.yaml"))
    assert cfg.acoustic_encoder.d_model == 768 and cfg.vocos.num_layers == 24
    assert cfg.code_frames == 375 and cfg.quantizer.num_levels_per_group == (8, 7, 6, 6)


def test_log_mel_matches():
    cfg = TINY.feature_extractor
    rng = np.random.default_rng(0)
    wav = np.zeros((2, cfg.n_samples), np.float32)
    wav[0, :70000] = rng.standard_normal(70000) * 0.1
    wav[1] = rng.standard_normal(cfg.n_samples) * 0.3
    want = jmel.log_mel(jmel.make_constants(cfg), jnp.asarray(wav), precision=HIGHEST)
    consts = tmel.MelConstants(cfg)
    got = tmel.log_mel(consts, t(wav))
    np.testing.assert_allclose(n(got), n(want), atol=5e-5)
    np.testing.assert_array_equal(n(consts.mel_fb), jmel.make_constants(cfg).mel_fb)
    lens = np.array([70000, 1, 0, 480000])
    np.testing.assert_array_equal(n(tmel.mel_lengths(t(lens), 160, 3000)), n(jmel.mel_lengths(jnp.asarray(lens), 160, 3000)))


def test_fsq_indices_exact_and_decode():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 50, 32)) * 2).astype(np.float32)
    lens = np.array([50, 17, 0])
    jc = jfsq.make_constants(TINY.quantizer)
    tc = tfsq.FSQConstants(TINY.quantizer)
    jz, jidx = jfsq.group_fsq_forward(jc, jnp.asarray(x), jnp.asarray(lens))
    tz, tidx = tfsq.group_fsq_forward(tc, t(x), t(lens))
    assert tidx.dtype == torch.int32 and tidx.shape == (8, 3, 50)
    np.testing.assert_array_equal(n(tidx), n(jidx))
    np.testing.assert_array_equal(n(tz), n(jz))
    np.testing.assert_array_equal(n(tfsq.group_fsq_decode(tc, tidx, t(lens))),
                                  n(jfsq.group_fsq_decode(jc, jidx, jnp.asarray(lens))))


def test_snake_activation_matches():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 57, 16)).astype(np.float32)
    alpha = (rng.standard_normal(16) * 0.3).astype(np.float32)
    beta = (rng.standard_normal(16) * 0.3).astype(np.float32)
    want = jsnake.activation1d(jsnake.make_alias_free_constants(), jnp.asarray(x), alpha, beta)
    got = tsnake.activation1d(tsnake.AliasFreeConstants(), t(x), t(alpha), t(beta))
    np.testing.assert_allclose(n(got), n(want), atol=1e-5)


def test_convs_match():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 31, 8)).astype(np.float32)
    w = rng.standard_normal((3, 8, 5)).astype(np.float32)  # JAX (W, I, O)
    b = rng.standard_normal(5).astype(np.float32)
    np.testing.assert_allclose(
        n(tconv.conv1d(t(x), t(w.transpose(2, 1, 0)), t(b), stride=2, padding=1)),
        n(jconv.conv1d(jnp.asarray(x), w, b, stride=2, padding=1)), atol=1e-5)
    np.testing.assert_allclose(
        n(tconv.conv_transpose1d(t(x), t(w.transpose(1, 2, 0)), t(b), stride=2)),
        n(jconv.conv_transpose1d(jnp.asarray(x), w, b, stride=2)), atol=1e-5)
    wd = rng.standard_normal((7, 8)).astype(np.float32)
    np.testing.assert_allclose(
        n(tconv.depthwise_conv1d_shifts(t(x), t(wd), t(b[:1].repeat(8)), padding=3)),
        n(jconv.depthwise_conv1d_shifts(jnp.asarray(x), wd, b[:1].repeat(8), padding=3)), atol=1e-6)


def test_encoder_matches(pair):
    params, model = pair
    rng = np.random.default_rng(4)
    mel = rng.standard_normal((2, 3000, 80)).astype(np.float32)
    lens = np.array([3000, 1234])
    want, wlen = jtransformer.encoder_forward(TINY.acoustic_encoder, params["encoder"], jnp.asarray(mel),
                                              jnp.asarray(lens), precision=HIGHEST)
    with torch.no_grad():
        got, glen = model.acoustic_encoder(t(mel), t(lens))
    np.testing.assert_array_equal(n(glen), n(wlen))
    np.testing.assert_allclose(n(got), n(want), atol=5e-5)


def test_decoder_matches(pair):
    params, model = pair
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 1500, 64)).astype(np.float32)
    lens = np.array([1500, 333])
    want, wlen = jtransformer.decoder_forward(TINY.acoustic_decoder, params["decoder"], jnp.asarray(h),
                                              jnp.asarray(lens), precision=HIGHEST)
    with torch.no_grad():
        got, glen = model.acoustic_decoder(t(h), t(lens))
    assert got.shape == (2, 3000, 80)
    np.testing.assert_array_equal(n(glen), n(wlen))
    np.testing.assert_allclose(n(got), n(want), atol=5e-5)


def test_transformer_layer_pflash_and_fused_impls_match_jax_kernels(pair):
    """One layer with the pflash core and the fused FFN (plain versions) vs
    the JAX layer with its Pallas kernels in interpret mode, in f32."""
    params, model = pair
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 130, 64)) * 0.5).astype(np.float32)
    lens = np.array([130, 61])
    lp = jax.tree.map(lambda a: a[0], params["encoder"]["layers"])
    want = jtransformer.transformer_layer(lp, jnp.asarray(x), None, 4, HIGHEST, jnp.asarray(lens),
                                          attn_impl="pflash:64", fused_ffn=True)
    with torch.no_grad():
        got = model.acoustic_encoder.layers[0](t(x), None, t(lens), "pflash", "fused")
    for i, ln in enumerate(lens):
        np.testing.assert_allclose(n(got)[i, :ln], n(want)[i, :ln], atol=3e-5)


@pytest.mark.parametrize("direction", ["down", "up"])
def test_samplers_match(pair, direction):
    params, model = pair
    rng = np.random.default_rng(7)
    af = jsnake.make_alias_free_constants()
    if direction == "down":
        x = rng.standard_normal((2, 1500, 64)).astype(np.float32)
        lens = np.array([1500, 701])
        want, wl = jsampling.frame_stack_down(TINY.downsample, af, params["downsample"], jnp.asarray(x),
                                              jnp.asarray(lens))
        got, gl = model.downsample(model.consts.af, t(x), t(lens))
    else:
        x = rng.standard_normal((2, 375, 32)).astype(np.float32)
        lens = np.array([375, 100])
        want, wl = jsampling.frame_stack_up(TINY.upsample, af, params["upsample"], jnp.asarray(x),
                                            jnp.asarray(lens))
        got, gl = model.upsample(model.consts.af, t(x), t(lens))
    np.testing.assert_array_equal(n(gl), n(wl))
    np.testing.assert_allclose(n(got.detach()), n(want), atol=2e-5)


@pytest.mark.parametrize("frame_valid", [None, 1337])
def test_vocos_matches(pair, frame_valid):
    """Including a virtual right edge that is not on any block boundary."""
    params, model = pair
    rng = np.random.default_rng(8)
    mel = rng.standard_normal((2, 3000, 80)).astype(np.float32)
    lens = np.array([3000, 1337])
    want, wl = jvocos.vocos_forward(TINY.vocos, jvocos.make_constants(TINY.vocos), params["vocos"],
                                    jnp.asarray(mel), jnp.asarray(lens),
                                    frame_valid=None if frame_valid is None else jnp.int32(frame_valid),
                                    precision=HIGHEST)
    with torch.no_grad():
        got, gl = model.vocos(t(mel), t(lens), frame_valid)
    keep = 3000 * 160 if frame_valid is None else frame_valid * 160
    np.testing.assert_array_equal(n(gl), n(wl))
    np.testing.assert_allclose(n(got)[:, :keep], n(want)[:, :keep], atol=3e-4)
