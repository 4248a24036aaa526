"""One codec GAN step of the port's step program (``train/codec_gan.py``)
against the JAX step, on the CPU: the TINY codec from the seeded
``informative_params`` through ``params_from_jax``, the full HiFi-GAN
discriminators, and the optimizers on the card's arithmetic
(``capturable``: step counts and bias corrections as tensors).

Tolerances: every loss term within rtol 1e-4 and the spectral-norm vectors
within 1e-6 (``tests/test_torch_codec_gan.py``); every trained parameter
within 2 lr of JAX's (``tests/test_torch_train.py``: Adam's first step moves
each element by at most lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from simwhisper_codec_tpu.models.codec import CodecConstants
from simwhisper_codec_tpu.train import codec_gan as jcg
from simwhisper_codec_tpu.train import gan as jgan
from simwhisper_codec_tpu_torch.train import codec_gan as tcg
from simwhisper_codec_tpu_torch.train import gan as tgan
from simwhisper_codec_tpu_torch.utils.checkpoint import discriminator_state_from_jax, params_from_jax

from test_torch_codec_gan import gan_batch
from test_torch_hifigan import port_disc, sn_convs
from test_torch_train_aot import LR, _threads, capturable_on_cpu, codec_state, torch_gan_batch  # noqa: F401
from torch_port import TINY, informative_params, jax_discriminator_params, n, port_model


def assert_params_near(module, ref: dict, atol: float, skip=()):
    checked = 0
    for name, p in module.named_parameters():
        if name.startswith(skip):
            continue
        np.testing.assert_allclose(n(p), n(ref[name]), rtol=0, atol=atol, err_msg=name)
        checked += 1
    assert checked > 0


def test_codec_gan_program_matches_jax(capturable_on_cpu):
    params, d_tree, b = informative_params(0), jax_discriminator_params(1), gan_batch(0)
    g_tx, d_tx = jcg.make_codec_gan_optimizers(TINY)
    state = jcg.init_codec_gan_state(TINY, params, d_tree, g_tx, d_tx)
    mc = jgan.make_mel_loss_constants()
    step = jax.jit(jcg.make_codec_gan_step(TINY, CodecConstants(TINY), mc, g_tx, d_tx))
    state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jgan.mel_loss_arrays(mc))

    model = port_model(params).train()
    tstate = codec_state(model, port_disc(d_tree), capturable=True)
    assert all(g["capturable"] for opt in (tstate.g_opt, tstate.d_opt) for g in opt.param_groups)
    got = tcg.codec_gan_step(tstate, torch_gan_batch(b), tgan.make_mel_loss_constants())
    program = next(iter(tstate.programs.values()))
    assert tstate.step == 1 and program.count == 1 and program.source == "eager"
    assert set(got) == set(metrics)
    for k, v in metrics.items():
        assert got[k] == pytest.approx(float(v), rel=1e-4), k
    d_new = jax.tree.map(np.asarray, state.d_params)
    modules = dict(tstate.discriminator.named_modules())
    for name, want in sn_convs(d_new):
        np.testing.assert_allclose(n(modules[name].u), want["u"], rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(n(modules[name].v_vec), want["v_vec"], rtol=0, atol=1e-6, err_msg=name)
    assert_params_near(model, params_from_jax(jax.tree.map(np.asarray, state.params)), 2 * LR,
                       skip=("acoustic_encoder.",))
    assert_params_near(tstate.discriminator, discriminator_state_from_jax(d_new), 2 * LR)


