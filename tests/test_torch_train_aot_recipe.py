"""Three epochs of the recipe's GAN step (``train/gan.py``'s step program),
each followed by the tensor rate's decay, against the JAX step and
``decay_learning_rate`` over ``optax.inject_hyperparams``, on the CPU: a
HiFi-GAN generator at 16 -> 64 channels and the full discriminators, the
optimizers on the card's arithmetic (``capturable``).

Tolerances: the rates equal bit for bit (both decay an f32 rate in f32);
every loss term within rtol 1e-4 and every parameter within 2 e lr of JAX's
after epoch e (each Adam step moves an element by at most about lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simwhisper_codec_tpu.train import gan as jgan
from simwhisper_codec_tpu_torch.train import gan as tgan
from simwhisper_codec_tpu_torch.utils.checkpoint import discriminator_state_from_jax, generator_state_from_jax

from test_torch_hifigan import CFG, audio, port_disc, port_gen
from test_torch_train_aot import LR, _threads, capturable_on_cpu  # noqa: F401
from test_torch_train_aot_codec import assert_params_near
from torch_port import jax_discriminator_params, jax_generator_params, n, t


@pytest.fixture(scope="module")
def recipe_reference():
    """Three epochs of the JAX recipe step (one batch each), each followed by
    ``decay_learning_rate``: per epoch the rates, the metrics and both trees."""
    g_tree, d_tree = jax_generator_params(CFG, 2), jax_discriminator_params(1)
    mc = jgan.make_mel_loss_constants()
    g_tx, d_tx = jgan.make_gan_optimizers(learning_rate=LR)
    state = jgan.GanTrainState(g_tree, d_tree, g_tx.init(g_tree), d_tx.init(d_tree), jnp.zeros((), jnp.int32))
    step = jax.jit(jgan.make_gan_train_step(CFG, mc, g_tx, d_tx))
    batches = [{"features": np.random.default_rng(5 + e).standard_normal((2, 8, 16)).astype(np.float32),
                "audio": audio(seed=3 + e)} for e in range(3)]
    epochs = []
    for b in batches:
        state, metrics = step(state, b, jgan.mel_loss_arrays(mc))
        state = jgan.decay_learning_rate(state, 0.9999)
        epochs.append({"metrics": {k: float(v) for k, v in metrics.items()},
                       "rates": [np.asarray(o.hyperparams["learning_rate"]) for o in (state.g_opt, state.d_opt)],
                       "g": generator_state_from_jax(jax.tree.map(np.asarray, state.g_params)),
                       "d": discriminator_state_from_jax(jax.tree.map(np.asarray, state.d_params))})
    return g_tree, d_tree, batches, epochs


def test_three_epochs_of_decayed_rates_match_jax(recipe_reference, capturable_on_cpu):
    g_tree, d_tree, batches, epochs = recipe_reference
    gen, disc = port_gen(g_tree), port_disc(d_tree)
    tstate = tgan.GanTrainState(gen, disc, tgan.adamw(gen.parameters(), LR, 0.8, 0.99, capturable=True),
                                tgan.adamw(disc.parameters(), LR, 0.8, 0.99, capturable=True))
    rates = [tstate.g_opt.param_groups[0]["lr"], tstate.d_opt.param_groups[0]["lr"]]
    mc = tgan.make_mel_loss_constants()
    for e, (b, want) in enumerate(zip(batches, epochs), start=1):
        got = tgan.gan_train_step(tstate, {k: t(v) for k, v in b.items()}, mc)
        tgan.decay_learning_rate(tstate, 0.9999)
        for k, v in want["metrics"].items():
            assert got[k] == pytest.approx(v, rel=1e-4), (e, k)
        for opt, rate, want_rate in zip((tstate.g_opt, tstate.d_opt), rates, want["rates"]):
            assert opt.param_groups[0]["lr"] is rate and rate.dtype == torch.float32 and rate.dim() == 0
            assert n(rate) == want_rate, (e, float(rate), float(want_rate))  # bit for bit, as f32
        assert_params_near(gen, want["g"], 2 * e * LR)
        assert_params_near(disc, want["d"], 2 * e * LR)
    assert tstate.step == 3 and [p.count for p in tstate.programs.values()] == [1]


