"""The port's training path against the JAX package's, on the CPU.

Same weights (a JAX ``init_params`` tree through ``params_from_jax``), same
numpy inputs.  Tolerances: codes equal and reconstructed audio within 2e-5;
the losses within 1e-5; gradients per tensor max|d| / max(|ref|, 1e-4) <=
1.5e-3 (the JAX package's multichip tolerance, MULTICHIP_r05.json); after
one AdamW step each parameter within 2 lr of JAX's (Adam's first step moves
each element by at most lr, whatever the gradient's size).

The weights are ``init_params(seed 0)`` with the latent projection
(``downsample.to_latent``) scaled x30, so that the latent has unit standard
deviation and the codes span the FSQ levels (367 distinct codes in the
batch).  At the raw init scale (latent std 0.033) every code is the zero
level, the decoder sees only zeros and the reconstruction is periodic, so
the log-spectral loss's gradient is dominated by f32 rounding at near-empty
STFT bins: there each package's f32 gradient differs from a float64 run of
the same math by up to 1.7e-3 (port) and 8.0e-4 (JAX), and the two by
2.5e-3, which no f32 implementation can be held to.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from simwhisper_codec_tpu.models import codec as jcodec
from simwhisper_codec_tpu.ops.mel import frame_signal as jax_frame_signal
from simwhisper_codec_tpu.train import gan as jgan
from simwhisper_codec_tpu.train import step as jstep
from simwhisper_codec_tpu_torch.models import codec as tcodec
from simwhisper_codec_tpu_torch.ops import fsq as tfsq
from simwhisper_codec_tpu_torch.ops.mel import frame_signal, reflect_pad
from simwhisper_codec_tpu_torch.train import gan as tgan
from simwhisper_codec_tpu_torch.train import step as tstep
from simwhisper_codec_tpu_torch.utils.checkpoint import params_from_jax

from torch_port import TINY, informative_params, n, port_model, t, torch_threads


@pytest.fixture(autouse=True)
def _threads():
    with torch_threads():
        yield


GRAD_TOL = 1.5e-3


def rel_err(got, want) -> float:
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-4)


def batch(b=4, t_mel=104, seed=0):
    rng_m, rng_a = np.random.default_rng(seed), np.random.default_rng(seed + 1)
    return {"mel": rng_m.standard_normal((b, t_mel, 80)).astype(np.float32),
            "mel_lens": np.array([t_mel] * (b - 1) + [t_mel - 24], np.int32),
            "audio": (rng_a.standard_normal((b, t_mel * 160)) * 0.1).astype(np.float32),
            "audio_lens": np.array([t_mel * 160] * (b - 1) + [(t_mel - 24) * 160], np.int32)}


def torch_batch(b: dict) -> dict:
    return {k: t(v).long() if k.endswith("lens") else t(v) for k, v in b.items()}


def test_ste_round_forward_is_round_and_gradient_is_identity():
    x = torch.tensor(np.concatenate([np.arange(-4.0, 4.01, 0.25), np.random.default_rng(0).uniform(-4, 4, 500)]),
                     dtype=torch.float32, requires_grad=True)
    y = tfsq.ste_round(x)
    assert torch.equal(y, torch.round(x))  # halves to even, bit for bit
    y.backward(torch.arange(x.numel(), dtype=torch.float32))
    assert torch.equal(x.grad, torch.arange(x.numel(), dtype=torch.float32))
    consts = tfsq.FSQConstants(TINY.quantizer)
    z = t(np.random.default_rng(1).standard_normal((2, 7, 32)).astype(np.float32) * 2.0)
    lens = torch.tensor([7, 4])
    codes, idx = tfsq.group_fsq_forward(consts, z, lens)
    codes_ste, idx_ste = tfsq.group_fsq_forward(consts, z, lens, ste=True)
    assert torch.equal(codes, codes_ste) and torch.equal(idx, idx_ste)


@pytest.mark.parametrize("left,right", [(512, 512), (0, 3), (200, 0)])
def test_reflect_pad_is_f_pad_reflect(left, right):
    x = t(np.random.default_rng(2).standard_normal((3, 1000)).astype(np.float32)).requires_grad_(True)
    y = reflect_pad(x, left, right)
    want = F.pad(x[:, None], (left, right), mode="reflect")[:, 0]
    assert torch.equal(y, want)
    g = t(np.random.default_rng(3).standard_normal(tuple(y.shape)).astype(np.float32))
    (gx,) = torch.autograd.grad(y, x, g)
    (gw,) = torch.autograd.grad(want, x, g)
    np.testing.assert_allclose(n(gx), n(gw), rtol=0, atol=1e-6)
    frames = frame_signal(x.detach(), 1024, 256, 1000 // 256 + 1)
    ref = np.asarray(jax_frame_signal(jnp.asarray(n(x)), 1024, 256, 1000 // 256 + 1))
    np.testing.assert_array_equal(n(frames), ref)


def test_training_forward_matches_jax():
    p, b = informative_params(), batch()
    fwd = jax.jit(lambda params, m, lens: jcodec.training_forward(TINY, jcodec.CodecConstants(TINY), params, m, lens))
    ref = fwd(p, jnp.asarray(b["mel"]), jnp.asarray(b["mel_lens"]))
    with tcodec.f32_precision("highest"):
        out = tcodec.training_forward(port_model(p), t(b["mel"]), t(b["mel_lens"]).long())
    np.testing.assert_array_equal(n(out["codes"]), n(ref["codes"]))
    np.testing.assert_array_equal(n(out["audio_lengths"]), n(ref["audio_lengths"]))
    np.testing.assert_allclose(n(out["reconstructed_audio"]), n(ref["reconstructed_audio"]), rtol=0, atol=2e-5)


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    recon = (rng.standard_normal((3, 9000)) * 0.1).astype(np.float32)
    target = (rng.standard_normal((3, 9000)) * 0.1).astype(np.float32)
    lens = np.array([9000, 7000, 2500], np.int32)
    want = jstep.reconstruction_loss(TINY, jnp.asarray(recon), jnp.asarray(target), jnp.asarray(lens))
    got = tstep.reconstruction_loss(t(recon), t(target), t(lens), tstep.make_spectral_consts())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(n(got[k]), n(want[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    mc = jgan.make_mel_loss_constants()
    np.testing.assert_allclose(n(tgan.log_mel_for_loss(tgan.make_mel_loss_constants(), t(recon))),
                               n(jgan.log_mel_for_loss(mc, jnp.asarray(recon))), rtol=0, atol=1e-5)


def _adam_mu(opt_state) -> dict:
    return opt_state.inner_states["train"].inner_state[0].mu


def test_train_step_matches_jax():
    """One ``train/step.py`` step: loss, gradients (from the JAX optimizer's
    first moment, which after one step is (1 - b1) g), the updated
    parameters, and the frozen encoder bit for bit."""
    p, b = informative_params(), batch()
    tx = jstep.make_optimizer(TINY)
    state = jstep.init_train_state(TINY, p, tx)
    step = jax.jit(jstep.make_train_step(TINY, jcodec.CodecConstants(TINY), tx))
    new_state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jstep.make_spectral_consts())
    mu = jax.tree.map(np.asarray, _adam_mu(new_state.opt_state))
    ref_grads = params_from_jax({**{k: mu[k] for k in mu if k != "encoder"}, "encoder": p["encoder"]})
    ref_params = params_from_jax(jax.tree.map(np.asarray, new_state.params))

    model = port_model(p).train()
    enc_before = {k: v.clone() for k, v in model.acoustic_encoder.state_dict().items()}
    tstate = tstep.TrainState(model, tstep.make_optimizer(model))
    got = tstep.train_step(tstate, torch_batch(b), tstep.make_spectral_consts())
    for k in ("loss", "wav_l1", "spec"):
        assert got[k] == pytest.approx(float(metrics[k]), rel=1e-4), k
    lr = tstate.opt.param_groups[0]["lr"]
    checked = 0
    for name, param in model.named_parameters():
        if name.startswith("acoustic_encoder."):
            assert param.grad is None and not param.requires_grad, name
            continue
        assert rel_err(n(param.grad), n(ref_grads[name]) / 0.1) <= GRAD_TOL, name
        np.testing.assert_allclose(n(param), n(ref_params[name]), rtol=0, atol=2 * lr, err_msg=name)
        checked += 1
    assert checked == sum(1 for k in ref_params if not k.startswith("acoustic_encoder."))
    for k, v in model.acoustic_encoder.state_dict().items():
        assert torch.equal(v, enc_before[k]), k


def test_in_process_resume_is_bit_exact(tmp_path):
    """Two codec GAN steps in a row against one step, a full-state save, a
    restore into fresh objects and the second step: equal losses bit for bit."""
    from simwhisper_codec_tpu_torch.experiments.codec.train import SMOKE
    from simwhisper_codec_tpu_torch.models.hifigan import Discriminator, init_hifigan
    from simwhisper_codec_tpu_torch.train.codec_gan import codec_gan_step, init_codec_gan_state
    from simwhisper_codec_tpu_torch.utils.checkpoint import load_training_state, save_training_state

    model = tcodec.init_params(SMOKE, torch.Generator().manual_seed(0))
    disc = init_hifigan(Discriminator(), torch.Generator().manual_seed(1))

    def fresh():
        return init_codec_gan_state(copy.deepcopy(model), copy.deepcopy(disc))

    b = batch(2, 16)
    steps = [torch_batch(b), torch_batch(batch(2, 16, seed=5))]
    mel_consts = tgan.make_mel_loss_constants()
    state = fresh()
    continuous = [codec_gan_step(state, s, mel_consts) for s in steps]
    state = fresh()
    first = codec_gan_step(state, steps[0], mel_consts)
    save_training_state(str(tmp_path / "ckpt_0000001.pt"), state.state_dict())
    assert not (tmp_path / "ckpt_0000001.pt.tmp").exists()
    resumed = fresh()
    resumed.load_state_dict(load_training_state(str(tmp_path / "ckpt_0000001.pt")))
    assert resumed.step == 1
    second = codec_gan_step(resumed, steps[1], mel_consts)
    assert [first, second] == continuous


def test_param_report_counts_like_jax():
    from simwhisper_codec_tpu.utils.params import count_params_by_module as jax_count
    from simwhisper_codec_tpu_torch.utils.params import count_params_by_module, format_param_report

    p = informative_params()
    model = port_model(p)
    names = {"encoder": "acoustic_encoder", "decoder": "acoustic_decoder"}
    assert count_params_by_module(model) == {names.get(k, k): v for k, v in jax_count(p).items()}
    report = format_param_report(model).splitlines()
    assert report[-1].split() == ["total", f"{jax_count(p)['total']:,}"] and len(report) == 7


def test_seed_everything_seeds_torch_and_numpy():
    from simwhisper_codec_tpu_torch.utils.seeding import seed_everything

    assert seed_everything(5) == 5
    a, x = torch.rand(3), np.random.rand(3)
    seed_everything(5)
    assert torch.equal(a, torch.rand(3)) and np.array_equal(x, np.random.rand(3))
