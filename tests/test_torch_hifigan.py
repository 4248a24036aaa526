"""The port's HiFi-GAN (``models/hifigan.py``, ``train/gan.py``) against the
JAX package's, on the CPU, with the same weights (JAX trees through
``generator_state_from_jax`` / ``discriminator_state_from_jax``).

Tolerances: forwards per output max|d| / max|ref| <= 1e-4; spectral-norm
vectors and weights within 1e-6; a GAN step's loss terms within rtol 1e-4,
its spectral-norm vectors within 1e-6 and every parameter within 2 lr of
JAX's (Adam's first step moves each element by at most lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simwhisper_codec_tpu.models import hifigan as jhg
from simwhisper_codec_tpu.train import gan as jgan
from simwhisper_codec_tpu_torch.models import hifigan as thg
from simwhisper_codec_tpu_torch.train import gan as tgan
from simwhisper_codec_tpu_torch.utils.checkpoint import discriminator_state_from_jax, generator_state_from_jax

from torch_port import jax_discriminator_params, jax_generator_params, n, t, torch_threads


@pytest.fixture(autouse=True)
def _threads():
    with torch_threads():
        yield


CFG = jhg.HifiGanConfig(in_channels=16, upsample_initial_channel=64)
TCFG = thg.HifiGanConfig(in_channels=16, upsample_initial_channel=64)


@pytest.fixture(scope="module")
def d_tree():
    return jax_discriminator_params(1)


@pytest.fixture(scope="module")
def g_tree():
    return jax_generator_params(CFG, 2)


def port_disc(tree) -> thg.Discriminator:
    d = thg.Discriminator()
    d.load_state_dict(discriminator_state_from_jax(tree))
    return d


def port_gen(tree) -> thg.Generator:
    g = thg.Generator(TCFG)
    g.load_state_dict(generator_state_from_jax(tree))
    return g


def rel(got, want) -> float:
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-30)


def audio(b=2, s=2560, seed=3):
    return (np.random.default_rng(seed).standard_normal((b, s)) * 0.1).astype(np.float32)


def sn_convs(tree):
    """(name, JAX SN conv) of the first MSD scale, in the port's key order."""
    msd0 = tree["msd"][0]
    return [(f"msd.0.convs.{i}", c) for i, c in enumerate(msd0["convs"])] + [("msd.0.conv_post", msd0["conv_post"])]


def test_generator_forward_matches_jax(g_tree):
    feats = np.random.default_rng(4).standard_normal((2, 8, 16)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, f: jhg.generator_forward(CFG, p, f))(g_tree, feats))
    with torch.no_grad():
        got = n(port_gen(g_tree)(t(feats)))
    assert got.shape == want.shape == (2, 8 * 320)
    assert rel(got, want) <= 1e-4


def test_discriminator_forward_matches_jax(d_tree):
    x = audio(s=2561)  # not a multiple of any period: every MPD pads by reflection
    scores, feats = jax.jit(jhg.discriminator_forward)(d_tree, x)
    with torch.no_grad():
        tscores, tfeats = port_disc(d_tree)(t(x))
    assert len(tscores) == len(scores) == 8 and len(tfeats) == 8
    for i, (a, b) in enumerate(zip(tscores, scores)):
        assert a.shape == b.shape and rel(n(a), np.asarray(b)) <= 1e-4, i
    for i, (fa, fb) in enumerate(zip(tfeats, feats)):
        for j, (a, b) in enumerate(zip(fa, fb)):
            # port NCHW / NCW, JAX NHWC / NWC
            b = np.moveaxis(np.asarray(b), -1, 1)
            assert a.shape == b.shape and rel(n(a), b) <= 1e-4, (i, j)


def test_sn_power_iteration_matches_jax(d_tree):
    d = port_disc(d_tree)
    d.power_iteration()
    stepped = jhg.spectral_norm_power_iteration(d_tree)
    modules = dict(d.named_modules())
    for (name, _), (_, want) in zip(sn_convs(d_tree), sn_convs(stepped)):
        m = modules[name]
        np.testing.assert_allclose(n(m.u), np.asarray(want["u"]), rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(n(m.v_vec), np.asarray(want["v_vec"]), rtol=0, atol=1e-6, err_msg=name)
        w = np.transpose(np.asarray(jhg.sn_weight(want)), (2, 1, 0))
        with torch.no_grad():
            np.testing.assert_allclose(n(m.weight()), w, rtol=1e-5, atol=1e-6, err_msg=name)


def test_sn_vectors_are_buffers_and_init_iterates():
    d = thg.init_hifigan(thg.Discriminator(), torch.Generator().manual_seed(0))
    names = {k for k, _ in d.named_parameters()}
    buffers = {k for k, _ in d.named_buffers()}
    assert {"msd.0.convs.0.u", "msd.0.convs.0.v_vec", "msd.0.conv_post.u"} <= buffers
    assert not any(k.endswith((".u", ".v_vec")) for k in names)
    assert not any(k.startswith(("msd.1", "msd.2", "mpd")) and k.endswith(".u") for k in buffers)
    conv = d.msd[0].convs[1]
    u0 = conv.u.clone()
    conv.power_iteration()  # after 15 iterations at init, u has nearly converged
    assert float((conv.u - u0).abs().max()) < 1e-2 and abs(float(conv.u.norm()) - 1.0) < 1e-5


def test_gan_step_matches_jax(g_tree, d_tree):
    """One ``gan.py`` step: every loss term, the spectral-norm vectors and both models' parameters."""
    lr = 2e-4
    mc = jgan.make_mel_loss_constants()
    g_tx, d_tx = jgan.make_gan_optimizers(learning_rate=lr)
    state = jgan.GanTrainState(g_tree, d_tree, g_tx.init(g_tree), d_tx.init(d_tree), jnp.zeros((), jnp.int32))
    feats = np.random.default_rng(5).standard_normal((2, 8, 16)).astype(np.float32)
    wav = audio()
    step = jax.jit(jgan.make_gan_train_step(CFG, mc, g_tx, d_tx))
    new, metrics = step(state, {"features": feats, "audio": wav}, jgan.mel_loss_arrays(mc))

    gen, disc = port_gen(g_tree), port_disc(d_tree)
    g_opt, d_opt = tgan.make_gan_optimizers(gen, disc, learning_rate=lr)
    tstate = tgan.GanTrainState(gen, disc, g_opt, d_opt)
    got = tgan.gan_train_step(tstate, {"features": t(feats), "audio": t(wav)}, tgan.make_mel_loss_constants())
    assert tstate.step == 1 and set(got) == set(metrics)
    for k, v in metrics.items():
        assert got[k] == pytest.approx(float(v), rel=1e-4), k
    for name, want in sn_convs(jax.tree.map(np.asarray, new.d_params)):
        m = dict(disc.named_modules())[name]
        np.testing.assert_allclose(n(m.u), want["u"], rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(n(m.v_vec), want["v_vec"], rtol=0, atol=1e-6, err_msg=name)
    for module, ref in ((gen, generator_state_from_jax(jax.tree.map(np.asarray, new.g_params))),
                        (disc, discriminator_state_from_jax(jax.tree.map(np.asarray, new.d_params)))):
        for k, v in module.named_parameters():
            np.testing.assert_allclose(n(v), n(ref[k]), rtol=0, atol=2 * lr, err_msg=k)


def test_decay_learning_rate():
    gen, disc = thg.Generator(TCFG), thg.Discriminator()
    g_opt, d_opt = tgan.make_gan_optimizers(gen, disc, learning_rate=2e-4)
    state = tgan.decay_learning_rate(tgan.GanTrainState(gen, disc, g_opt, d_opt), gamma=0.5)
    assert [g["lr"] for g in state.g_opt.param_groups + state.d_opt.param_groups] == [1e-4, 1e-4]
    assert g_opt.defaults["weight_decay"] == 1e-4 and g_opt.defaults["betas"] == (0.8, 0.99)
    assert g_opt.defaults["eps"] == 1e-8


def test_sample_segment_matches_jax():
    rng = np.random.default_rng(7)
    wav = rng.standard_normal(32000).astype(np.float32)
    feats = rng.standard_normal((100, 16)).astype(np.float32)
    for seed in range(3):
        for size in (8960, 40000):  # an aligned crop, and a segment longer than the audio (padded)
            a, f = tgan.sample_segment(np.random.default_rng(seed), wav, feats, size, 320)
            ja, jf = jgan.sample_segment(np.random.default_rng(seed), wav, feats, size, 320)
            np.testing.assert_array_equal(a, ja)
            np.testing.assert_array_equal(f, jf)
            assert a.shape == (size,) and f.shape == (size // 320, 16)
