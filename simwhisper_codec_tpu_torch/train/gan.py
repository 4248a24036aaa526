"""HiFi-GAN adversarial training: the loss family and the two-optimizer step.

Counterpart of ``simwhisper_codec_tpu/train/gan.py`` (the reference's
SpeechBrain GAN loop, ``hifigan_continue_whisper/train.py:106-151``): per
batch, a D step on the detached fake, then fresh D scores with the updated
D, then the G step; AdamW (lr 2e-4, betas 0.8 / 0.99, eps 1e-8 and weight
decay 1e-4, optax's defaults) for each model, ExponentialLR (gamma 0.9999)
applied per epoch by the caller; losses MSE-GAN (weight 1) + feature match
(10) + L1 log-mel (45), ``hparams/train.yaml:140-228``.

Every step runs under ``f32_precision("highest")`` (no TF32), the
counterpart of the JAX package's f32 training.  ``dist`` (a
``parallel.dist.DistContext``) averages gradients and metrics over ranks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from simwhisper_codec_tpu_torch.models.codec import f32_precision
from simwhisper_codec_tpu_torch.models.hifigan import Discriminator, Generator
from simwhisper_codec_tpu_torch.ops.mel import frame_signal, slaney_mel_filter_bank
from simwhisper_codec_tpu_torch.parallel.dist import DistContext, average_grads, average_metrics


class MelLossConstants(nn.Module):
    """torchaudio-style MelSpectrogram bases (power 1, slaney norm and scale)
    as non-persistent buffers."""

    def __init__(self, sample_rate: int = 16000, n_fft: int = 1024, win: int = 1024, hop: int = 256,
                 n_mels: int = 80, f_min: float = 0.0, f_max: Optional[float] = None):
        super().__init__()
        f_max = f_max if f_max is not None else sample_rate / 2
        n_freq = n_fft // 2 + 1
        fb = slaney_mel_filter_bank(n_freq, n_mels, f_min, f_max, sample_rate)
        n = np.arange(win, dtype=np.float64)
        window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win))
        if win < n_fft:
            lp = (n_fft - win) // 2
            window = np.pad(window, (lp, n_fft - win - lp))
        phase = 2.0 * np.pi * np.outer(np.arange(n_fft, dtype=np.float64), np.arange(n_freq, dtype=np.float64)) / n_fft
        for name, arr in (("basis_re", np.cos(phase) * window[:, None]), ("basis_im", -np.sin(phase) * window[:, None]),
                          ("mel_fb", fb)):
            self.register_buffer(name, torch.from_numpy(arr.astype(np.float32)), persistent=False)
        self.n_fft = n_fft
        self.hop = hop


def make_mel_loss_constants(sample_rate: int = 16000, n_fft: int = 1024, win: int = 1024, hop: int = 256,
                            n_mels: int = 80, f_min: float = 0.0, f_max: Optional[float] = None) -> MelLossConstants:
    return MelLossConstants(sample_rate, n_fft, win, hop, n_mels, f_min, f_max)


def log_mel_for_loss(consts: MelLossConstants, wav: torch.Tensor) -> torch.Tensor:
    """(B, S) -> (B, S // hop + 1, n_mels) log(clamp(mel(|STFT|), 1e-5))."""
    frames = frame_signal(wav, consts.n_fft, consts.hop, wav.shape[-1] // consts.hop + 1)
    re = frames @ consts.basis_re
    im = frames @ consts.basis_im
    mag = torch.sqrt(re * re + im * im + 1e-12)
    return torch.log(torch.clamp(mag @ consts.mel_fb, min=1e-5))


# -- losses (SpeechBrain's HifiGAN loss family) --------------------------------


def mse_g_loss(scores_fake: Sequence[torch.Tensor]) -> torch.Tensor:
    return sum(torch.mean((1.0 - s) ** 2) for s in scores_fake)


def mse_d_loss(scores_real, scores_fake) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    loss_real = sum(torch.mean((1.0 - s) ** 2) for s in scores_real)
    loss_fake = sum(torch.mean(s ** 2) for s in scores_fake)
    return loss_real + loss_fake, loss_real, loss_fake


def feature_match_loss(feats_real, feats_fake) -> torch.Tensor:
    """Mean over every feature map of mean |real - fake|; the real maps carry no gradient."""
    terms = [torch.mean(torch.abs(fr.detach() - ff))
             for fr_list, ff_list in zip(feats_real, feats_fake) for fr, ff in zip(fr_list, ff_list)]
    return sum(terms) / max(len(terms), 1)


def adamw(params, learning_rate: float, b1: float, b2: float, weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """``optax.adamw`` (eps 1e-8; weight decay 1e-4 unless given): torch's own
    default decay is 1e-2."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2), eps=1e-8, weight_decay=weight_decay)


def discriminator_step(disc: Discriminator, d_opt: torch.optim.Optimizer, fake: torch.Tensor, real: torch.Tensor,
                       dist: Optional[DistContext]) -> Dict[str, torch.Tensor]:
    """Advance the spectral-norm vectors, then one D update on the detached
    fake and the real audio; returns the D losses."""
    disc.power_iteration()
    sf, _ = disc(fake.detach())
    sr, _ = disc(real)
    loss, loss_real, loss_fake = mse_d_loss(sr, sf)
    d_opt.zero_grad(set_to_none=True)
    loss.backward()
    average_grads(dist or DistContext(), disc.parameters())
    d_opt.step()
    return {"d_loss": loss.detach(), "d_real": loss_real.detach(), "d_fake": loss_fake.detach()}


def generator_losses(disc: Discriminator, mel_consts: MelLossConstants, fake: torch.Tensor, real: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(adversarial, feature-match, L1 log-mel) of ``fake`` against the updated
    D; the real branch runs without a graph."""
    sf, ff = disc(fake)
    with torch.no_grad():
        _, fr = disc(real)
        mel_real = log_mel_for_loss(mel_consts, real)
    l1 = torch.mean(torch.abs(log_mel_for_loss(mel_consts, fake) - mel_real))
    return mse_g_loss(sf), feature_match_loss(fr, ff), l1


def generator_update(loss: torch.Tensor, params: List[nn.Parameter], opt: torch.optim.Optimizer,
                     dist: Optional[DistContext]) -> None:
    """Backward into ``params`` only (D's weights take no gradient), average, step."""
    opt.zero_grad(set_to_none=True)
    loss.backward(inputs=params)
    average_grads(dist or DistContext(), params)
    opt.step()


@dataclass
class GanTrainState:
    generator: Generator
    discriminator: Discriminator
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    step: int = 0


def make_gan_optimizers(generator: nn.Module, discriminator: nn.Module, learning_rate: float = 2e-4,
                        b1: float = 0.8, b2: float = 0.99):
    """The AdamW pair; ``decay_learning_rate`` scales both learning rates."""
    return (adamw(generator.parameters(), learning_rate, b1, b2),
            adamw(discriminator.parameters(), learning_rate, b1, b2))


def gan_train_step(state: GanTrainState, batch: Dict[str, torch.Tensor], mel_consts: MelLossConstants,
                   dist: Optional[DistContext] = None, mseg_weight: float = 1.0,
                   feat_match_weight: float = 10.0, l1_spec_weight: float = 45.0) -> Dict[str, float]:
    """G forward -> D step (detached fake) -> fresh scores -> G step.
    ``batch``: {"features": (B, T, C), "audio": (B, T * 320)}; returns the
    metrics as floats (averaged over ranks)."""
    with f32_precision("highest"):
        fake = state.generator(batch["features"])
        metrics = discriminator_step(state.discriminator, state.d_opt, fake, batch["audio"], dist)
        adv, fm, l1 = generator_losses(state.discriminator, mel_consts, fake, batch["audio"])
        total = mseg_weight * adv + feat_match_weight * fm + l1_spec_weight * l1
        generator_update(total, list(state.generator.parameters()), state.g_opt, dist)
    state.step += 1
    metrics.update(g_loss=total.detach(), adv=adv.detach(), feat_match=fm.detach(), l1_spec=l1.detach())
    return average_metrics(dist or DistContext(), metrics)


def decay_learning_rate(state, gamma: float = 0.9999):
    """Per-epoch ExponentialLR on both optimizers (train.yaml:246-252)."""
    for opt in (state.g_opt, state.d_opt):
        for group in opt.param_groups:
            group["lr"] *= gamma
    return state


def sample_segment(rng: np.random.Generator, audio: np.ndarray, features: np.ndarray, segment_size: int,
                   feature_hop: int) -> Tuple[np.ndarray, np.ndarray]:
    """Aligned random crop: an audio segment and its feature window; starts are
    drawn on the feature grid (the reference's ``sample_interval``,
    hifigan_continue_whisper/train.py:314-334)."""
    feat_len = segment_size // feature_hop
    max_start = min(len(audio) // feature_hop, len(features)) - feat_len
    start = int(rng.integers(0, max_start + 1)) if max_start > 0 else 0
    a = audio[start * feature_hop: start * feature_hop + segment_size]
    f = features[start: start + feat_len]
    if len(a) < segment_size:
        a = np.pad(a, (0, segment_size - len(a)))
    if len(f) < feat_len:
        f = np.pad(f, ((0, feat_len - len(f)), (0, 0)))
    return a, f
