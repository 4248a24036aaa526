"""The codec's adversarial trainer step: frozen encoder, FSQ straight-through,
HiFi-GAN MPD + MSD.

Counterpart of ``simwhisper_codec_tpu/train/codec_gan.py``: the codec
training forward against the HiFi-GAN discriminators with MSE-GAN (weight
1) + feature match (10) + L1 log-mel (45).  Per step: codec forward ->
spectral-norm power iteration -> D step on the detached reconstruction ->
G step against the updated D.  The G loss reuses the step's one codec
forward (the JAX step runs it twice with the same parameters).  Optimizers:
AdamW betas 0.8 / 0.99, eps 1e-8, weight decay 1e-4 (optax's default), the
codec's over every parameter but the frozen encoder's.

The step is one program per batch signature (``train/gan.py``'s
``step_program``), the twin of the JAX trainer's ``warm_jit`` / ``jax.jit``
of ``make_codec_gan_step``: a CUDA graph on the card after one eager
warm-up step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch

from simwhisper_codec_tpu_torch.models.codec import SimWhisperCodec, f32_precision, training_forward
from simwhisper_codec_tpu_torch.models.hifigan import Discriminator
from simwhisper_codec_tpu_torch.parallel.dist import DistContext, average_metrics
from simwhisper_codec_tpu_torch.train.gan import (
    MelLossConstants,
    adamw,
    discriminator_step,
    generator_losses,
    generator_update,
    step_program,
)
from simwhisper_codec_tpu_torch.train.step import trainable_parameters
from simwhisper_codec_tpu_torch.utils import aot


@dataclass
class CodecGanState:
    model: SimWhisperCodec
    discriminator: Discriminator
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    step: int = 0
    programs: Dict[tuple, aot.StepProgram] = field(default_factory=dict, repr=False)  # see ``step_program``

    def state_dict(self) -> dict:
        """Everything an exact resume needs: both models (the spectral-norm
        vectors included), both optimizers' moments and steps, the step."""
        return {"model": self.model.state_dict(), "discriminator": self.discriminator.state_dict(),
                "g_opt": self.g_opt.state_dict(), "d_opt": self.d_opt.state_dict(), "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.discriminator.load_state_dict(sd["discriminator"])
        self.g_opt.load_state_dict(sd["g_opt"])
        self.d_opt.load_state_dict(sd["d_opt"])
        self.step = int(sd["step"])


def make_codec_gan_optimizers(model: SimWhisperCodec, discriminator: Discriminator, learning_rate: float = 2e-4
                              ) -> Tuple[torch.optim.AdamW, torch.optim.AdamW]:
    return (adamw(trainable_parameters(model), learning_rate, 0.8, 0.99),
            adamw(discriminator.parameters(), learning_rate, 0.8, 0.99))


def init_codec_gan_state(model: SimWhisperCodec, discriminator: Discriminator, learning_rate: float = 2e-4
                         ) -> CodecGanState:
    g_opt, d_opt = make_codec_gan_optimizers(model, discriminator, learning_rate)
    return CodecGanState(model, discriminator, g_opt, d_opt)


def codec_gan_body(state: CodecGanState, mel_consts: MelLossConstants, dist: Optional[DistContext],
                   adv_weight: float, feat_match_weight: float, mel_weight: float) -> Callable:
    """The program of ``codec_gan_step``: (mel, mel_lens, audio) -> this
    rank's metrics as 0-d tensors; it reads nothing on the host."""

    def body(mel: torch.Tensor, mel_lens: torch.Tensor, audio: torch.Tensor) -> Dict[str, torch.Tensor]:
        with f32_precision("highest"):
            recon = training_forward(state.model, mel, mel_lens)["reconstructed_audio"]
            t = min(recon.shape[-1], audio.shape[-1])
            fake, real = recon[..., :t], audio[..., :t]
            d_loss = discriminator_step(state.discriminator, state.d_opt, fake, real, dist)["d_loss"]
            adv, fm, mel_l1 = generator_losses(state.discriminator, mel_consts, fake, real)
            total = adv_weight * adv + feat_match_weight * fm + mel_weight * mel_l1
            params = [p for group in state.g_opt.param_groups for p in group["params"]]
            g_loss = generator_update(total, params, state.g_opt, dist)
        return {"g_loss": g_loss, "d_loss": d_loss, "adv": adv.detach(), "feat_match": fm.detach(),
                "mel_l1": mel_l1.detach()}

    return body


def codec_gan_program(state: CodecGanState, mel_consts: MelLossConstants, dist: Optional[DistContext] = None,
                      adv_weight: float = 1.0, feat_match_weight: float = 10.0,
                      mel_weight: float = 45.0) -> aot.StepProgram:
    """The step program ``codec_gan_step`` runs for these arguments."""
    weights = (adv_weight, feat_match_weight, mel_weight)
    return step_program(state, "codec_gan_step", (id(mel_consts),) + weights,
                        lambda: codec_gan_body(state, mel_consts, dist, *weights),
                        (state.model, state.discriminator), dist)


def codec_gan_step(state: CodecGanState, batch: Dict[str, torch.Tensor], mel_consts: MelLossConstants,
                   dist: Optional[DistContext] = None, adv_weight: float = 1.0, feat_match_weight: float = 10.0,
                   mel_weight: float = 45.0) -> Dict[str, float]:
    """One D update and one G update.  ``batch``: {"mel": (B, T_mel, n_mels),
    "mel_lens": (B,), "audio": (B, S)}; returns {"g_loss", "d_loss", "adv",
    "feat_match", "mel_l1"} as floats (averaged over ranks)."""
    program = codec_gan_program(state, mel_consts, dist, adv_weight, feat_match_weight, mel_weight)
    metrics = program(batch["mel"], batch["mel_lens"], batch["audio"])
    state.step += 1
    return average_metrics(dist or DistContext(), metrics)
