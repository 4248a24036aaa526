"""The codec's reconstruction training step (no GAN), with the encoder frozen.

Counterpart of ``simwhisper_codec_tpu/train/step.py``: the training forward
(mel -> frozen encoder -> down -> FSQ (straight-through) -> up -> decoder ->
Vocos), a multi-scale spectral + L1 waveform loss, and AdamW (betas 0.9 /
0.99, weight decay 1e-2).  The frozen encoder (``acoustic_encoder``; the
JAX tree's ``encoder``) takes ``requires_grad_(False)`` and stays out of
the optimizer, so not even weight decay moves it.  Steps run under
``f32_precision("highest")``; ``dist`` averages gradients and metrics over
ranks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from simwhisper_codec_tpu_torch.models.codec import SimWhisperCodec, f32_precision, training_forward
from simwhisper_codec_tpu_torch.ops.mel import frame_signal
from simwhisper_codec_tpu_torch.parallel.dist import DistContext, average_grads, average_metrics

SPECTRAL_SCALES: Tuple[Tuple[int, int], ...] = ((512, 128), (1024, 256), (2048, 512))


class SpectralLossConsts(nn.Module):
    """Windowed DFT bases of the multi-scale spectral loss, one pair a scale
    (non-persistent buffers ``cos{i}`` / ``sin{i}``)."""

    def __init__(self, scales: Tuple[Tuple[int, int], ...] = SPECTRAL_SCALES):
        super().__init__()
        self.scales = tuple(scales)
        for i, (n_fft, _hop) in enumerate(self.scales):
            n = np.arange(n_fft)
            window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))
            phase = 2.0 * np.pi * np.outer(n, np.arange(n_fft // 2 + 1)) / n_fft
            self.register_buffer(f"cos{i}", torch.from_numpy((np.cos(phase) * window[:, None]).astype(np.float32)),
                                 persistent=False)
            self.register_buffer(f"sin{i}", torch.from_numpy((-np.sin(phase) * window[:, None]).astype(np.float32)),
                                 persistent=False)

    def bases(self):
        """[(n_fft, hop, cos basis, sin basis)] per scale."""
        return [(n_fft, hop, getattr(self, f"cos{i}"), getattr(self, f"sin{i}"))
                for i, (n_fft, hop) in enumerate(self.scales)]


def make_spectral_consts(scales: Tuple[Tuple[int, int], ...] = SPECTRAL_SCALES) -> SpectralLossConsts:
    return SpectralLossConsts(scales)


def stft_mag(x: torch.Tensor, hop: int, cos_b: torch.Tensor, sin_b: torch.Tensor) -> torch.Tensor:
    """|STFT| (B, S // hop, n_fft // 2 + 1) by framing and a matmul DFT."""
    frames = frame_signal(x, cos_b.shape[0], hop, x.shape[-1] // hop)
    re = frames @ cos_b
    im = frames @ sin_b
    return torch.sqrt(re * re + im * im + 1e-9)


def reconstruction_loss(recon: torch.Tensor, target: torch.Tensor, lengths: torch.Tensor,
                        spec_consts: SpectralLossConsts) -> Dict[str, torch.Tensor]:
    """Masked L1 waveform loss + multi-scale |STFT| L1 and log-|STFT| L1
    (scales longer than the signal are skipped)."""
    t = min(recon.shape[-1], target.shape[-1])
    recon, target = recon[..., :t], target[..., :t]
    mask = (torch.arange(t, device=recon.device)[None, :] < lengths[:, None]).to(recon.dtype)
    denom = torch.clamp(mask.sum(), min=1.0)
    wav_l1 = torch.sum(torch.abs(recon - target) * mask) / denom
    spec = torch.zeros((), dtype=recon.dtype, device=recon.device)
    for n_fft, hop, cos_b, sin_b in spec_consts.bases():
        if t < n_fft:
            continue
        mr = stft_mag(recon, hop, cos_b, sin_b)
        mt = stft_mag(target, hop, cos_b, sin_b)
        spec = spec + torch.mean(torch.abs(mr - mt))
        spec = spec + torch.mean(torch.abs(torch.log(mr + 1e-5) - torch.log(mt + 1e-5)))
    return {"loss": wav_l1 + spec, "wav_l1": wav_l1, "spec": spec}


def trainable_parameters(model: SimWhisperCodec) -> List[nn.Parameter]:
    """Every codec parameter but the frozen encoder's, which this also freezes."""
    model.acoustic_encoder.requires_grad_(False)
    return [p for p in model.parameters() if p.requires_grad]


def make_optimizer(model: SimWhisperCodec, learning_rate: float = 1e-4, weight_decay: float = 1e-2
                   ) -> torch.optim.AdamW:
    return torch.optim.AdamW(trainable_parameters(model), lr=learning_rate, betas=(0.9, 0.99), eps=1e-8,
                             weight_decay=weight_decay)


@dataclass
class TrainState:
    model: SimWhisperCodec
    opt: torch.optim.Optimizer
    step: int = 0


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], spec_consts: SpectralLossConsts,
               dist: Optional[DistContext] = None) -> Dict[str, float]:
    """One update.  ``batch``: {"mel": (B, T_mel, n_mels), "mel_lens": (B,),
    "audio": (B, S), "audio_lens": (B,)}; returns the metrics as floats."""
    params = [p for group in state.opt.param_groups for p in group["params"]]
    with f32_precision("highest"):
        out = training_forward(state.model, batch["mel"], batch["mel_lens"])
        losses = reconstruction_loss(out["reconstructed_audio"], batch["audio"], batch["audio_lens"], spec_consts)
        state.opt.zero_grad(set_to_none=True)
        losses["loss"].backward(inputs=params)
        average_grads(dist or DistContext(), params)
        state.opt.step()
    state.step += 1
    return average_metrics(dist or DistContext(), losses)
