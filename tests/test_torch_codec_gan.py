"""Two codec GAN steps (``train/codec_gan.py``) of the port against the JAX
package's, on the CPU: the TINY codec (weights from ``informative_params``,
see ``torch_port.py``) against the full HiFi-GAN discriminators.

Tolerances: every loss term of both steps within rtol 1e-4, the
spectral-norm vectors after both steps within 1e-6; the frozen encoder bit
for bit unchanged; the optimizers match optax's defaults (betas 0.8 / 0.99,
eps 1e-8, weight decay 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simwhisper_codec_tpu.models.codec import CodecConstants
from simwhisper_codec_tpu.train import codec_gan as jcg
from simwhisper_codec_tpu.train.gan import make_mel_loss_constants, mel_loss_arrays
from simwhisper_codec_tpu_torch.models import hifigan as thg
from simwhisper_codec_tpu_torch.train import codec_gan as tcg
from simwhisper_codec_tpu_torch.train.gan import make_mel_loss_constants as t_mel_loss_constants
from simwhisper_codec_tpu_torch.utils.checkpoint import discriminator_state_from_jax

from torch_port import TINY, informative_params, jax_discriminator_params, n, port_model, t, torch_threads


@pytest.fixture(autouse=True)
def _threads():
    with torch_threads():
        yield


def gan_batch(seed: int, b: int = 2, t_mel: int = 16) -> dict:
    rng = np.random.default_rng(seed)  # 16 mel frames -> 2 codes -> 2560 samples
    return {"mel": rng.standard_normal((b, t_mel, 80)).astype(np.float32),
            "mel_lens": np.full((b,), t_mel, np.int32),
            "audio": (rng.standard_normal((b, t_mel * 160)) * 0.1).astype(np.float32),
            "audio_lens": np.full((b,), t_mel * 160, np.int32)}


def test_two_codec_gan_steps_match_jax():
    params, d_tree = informative_params(0), jax_discriminator_params(1)
    batches = [gan_batch(0), gan_batch(1)]

    g_tx, d_tx = jcg.make_codec_gan_optimizers(TINY)
    state = jcg.init_codec_gan_state(TINY, params, d_tree, g_tx, d_tx)
    mc = make_mel_loss_constants()
    step = jax.jit(jcg.make_codec_gan_step(TINY, CodecConstants(TINY), mc, g_tx, d_tx))
    want = []
    for b in batches:
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()}, mel_loss_arrays(mc))
        want.append({k: float(v) for k, v in metrics.items()})

    model = port_model(params).train()
    disc = thg.Discriminator()
    disc.load_state_dict(discriminator_state_from_jax(d_tree))
    enc_before = {k: v.clone() for k, v in model.acoustic_encoder.state_dict().items()}
    tstate = tcg.init_codec_gan_state(model, disc)
    for opt in (tstate.g_opt, tstate.d_opt):
        assert opt.defaults["betas"] == (0.8, 0.99) and opt.defaults["weight_decay"] == 1e-4
        assert opt.defaults["eps"] == 1e-8 and opt.defaults["lr"] == 2e-4
    tmc = t_mel_loss_constants()
    got = [tcg.codec_gan_step(tstate, {"mel": t(b["mel"]), "mel_lens": t(b["mel_lens"]).long(),
                                       "audio": t(b["audio"])}, tmc) for b in batches]
    assert tstate.step == 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (g, w)
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-4), (i, k, g[k], w[k])

    msd0 = jax.tree.map(np.asarray, state.d_params["msd"][0])
    for name, conv in [(f"convs.{i}", c) for i, c in enumerate(msd0["convs"])] + [("conv_post", msd0["conv_post"])]:
        m = dict(disc.msd[0].named_modules())[name]
        np.testing.assert_allclose(n(m.u), conv["u"], rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(n(m.v_vec), conv["v_vec"], rtol=0, atol=1e-6, err_msg=name)
    for k, v in model.acoustic_encoder.state_dict().items():
        assert torch.equal(v, enc_before[k]), k
    trainable = {id(p) for group in tstate.g_opt.param_groups for p in group["params"]}
    assert not any(id(p) in trainable for p in model.acoustic_encoder.parameters())
    assert len(trainable) == sum(1 for _ in model.parameters()) - sum(1 for _ in model.acoustic_encoder.parameters())
