"""Analytic FLOPs ledger for the codec (MFU accounting).

A copy of the JAX package's ``utils/flops.py``: multiply-adds count as 2
FLOPs for every matmul and convolution of the tokenize and detokenize
programs at a given config, per 30 s chunk per utterance:

  wav 480000 -> mel (3000, 80) -> encoder (1500, 768) -> latent (375, 32)
  -> codes -> decoder -> mel (3000, 80) -> Vocos (3000, 512) -> wav

Elementwise work (snake, GELU, LN, softmax) is left out, as there: it runs
on the CUDA cores and is bound by memory, so counting it would overstate
MFU.  ``peak_tflops`` gives the published dense bf16 tensor-core peak of an
NVIDIA part by its name; MFU = ledger FLOPs per second over that peak.
"""

from __future__ import annotations

from typing import Dict


def _transformer_flops(t: int, d: int, f: int, layers: int) -> int:
    """Per-layer: QKVO projections + scores/AV + 2-matmul FFN."""
    qkvo = 8 * t * d * d
    attn = 4 * t * t * d
    ffn = 4 * t * d * f
    return layers * (qkvo + attn + ffn)


def _resunit_stack_flops(t: int, c: int, n_units: int = 3, k: int = 7,
                         resample_k: int = 12) -> int:
    """FrameStackDown/UpConv residual units: per unit a k7 dilated conv, a k1
    conv, and 2 alias-free activations (2x up + 2x down depthwise taps)."""
    conv7 = 2 * t * k * c * c
    conv1 = 2 * t * c * c
    # upsample2x produces 2t samples from k/2-tap FMAs per phase; downsample
    # mirrors it; two Activation1d per unit
    resample = 2 * (2 * (2 * t) * (resample_k // 2) * c)
    return n_units * (conv7 + conv1 + resample)


def codec_flops(cfg) -> Dict[str, int]:
    """FLOPs per utterance per 30 s chunk, by component (see module doc)."""
    t_mel = cfg.feature_extractor.nb_max_frames  # 3000
    n_fft = cfg.feature_extractor.n_fft  # 400
    n_freq = n_fft // 2 + 1
    n_mels = cfg.feature_extractor.feature_size if hasattr(cfg.feature_extractor, "feature_size") else 80
    d = cfg.acoustic_encoder.d_model
    f_enc = cfg.acoustic_encoder.encoder_ffn_dim
    l_enc = cfg.acoustic_encoder.encoder_layers
    f_dec = cfg.acoustic_decoder.decoder_ffn_dim
    l_dec = cfg.acoustic_decoder.decoder_layers
    t_enc = t_mel // 2  # conv2 stride 2
    s = cfg.downsample.stack_factor
    t_lat = t_enc // s
    h_dim = cfg.downsample.hidden_dim
    lat = cfg.downsample.latent_dim
    v = cfg.vocos

    ledger = {}
    # --- tokenize -----------------------------------------------------------
    ledger["mel_dft"] = 2 * t_mel * n_fft * (2 * n_freq)
    ledger["mel_filterbank"] = 2 * t_mel * n_freq * n_mels
    ledger["encoder_convs"] = (
        2 * t_mel * 3 * n_mels * d + 2 * t_enc * 3 * d * d
    )
    ledger["encoder_transformer"] = _transformer_flops(t_enc, d, f_enc, l_enc)
    ledger["downsample"] = (
        2 * t_lat * (d * s) * h_dim
        + _resunit_stack_flops(t_lat, h_dim)
        + 2 * t_lat * h_dim * lat
    )
    # --- detokenize ---------------------------------------------------------
    ledger["upsample"] = (
        2 * t_lat * lat * h_dim
        + _resunit_stack_flops(t_lat, h_dim)
        + 2 * t_lat * h_dim * (d * s)
    )
    ledger["decoder_transformer"] = _transformer_flops(t_enc, d, f_dec, l_dec)
    ledger["decoder_deconvs"] = 2 * t_mel * 3 * d * d + 2 * t_mel * 3 * d * n_mels
    vocos_freq = v.n_fft // 2 + 1
    ledger["vocos_embed"] = 2 * t_mel * 7 * v.input_channels * v.dim
    ledger["vocos_convnext"] = v.num_layers * (
        2 * t_mel * 7 * v.dim  # depthwise k7
        + 4 * t_mel * v.dim * v.intermediate_dim  # pw1 + pw2
    )
    ledger["vocos_head"] = 2 * t_mel * v.dim * (v.n_fft + 2)
    ledger["istft"] = 2 * 2 * t_mel * vocos_freq * v.n_fft  # cos+sin irDFT matmuls

    tok = (
        ledger["mel_dft"] + ledger["mel_filterbank"] + ledger["encoder_convs"]
        + ledger["encoder_transformer"] + ledger["downsample"]
    )
    detok = (
        ledger["upsample"] + ledger["decoder_transformer"] + ledger["decoder_deconvs"]
        + ledger["vocos_embed"] + ledger["vocos_convnext"] + ledger["vocos_head"]
        + ledger["istft"]
    )
    ledger["total_tokenize"] = tok
    ledger["total_detokenize"] = detok
    ledger["total"] = tok + detok
    return ledger


# Published dense (no sparsity) bf16 tensor-core peak, TFLOP/s, by the name
# CUDA reports; the more specific names come first.
PEAK_TFLOPS_BF16 = {
    "H100 NVL": 835.0,
    "H100 PCIe": 756.0,
    "H100 80GB HBM3": 989.4,
    "H100 SXM": 989.4,
}


def peak_tflops(device) -> float:
    """Peak dense bf16 TFLOP/s of a ``torch.device`` (its CUDA name) or of a
    device name such as ``"NVIDIA H100 80GB HBM3"``; 0.0 if unknown."""
    import torch

    if isinstance(device, str):
        try:  # "cuda", "cuda:1", "cpu": a device, not a name
            device = torch.device(device)
        except RuntimeError:
            name = device
    if isinstance(device, torch.device):
        if device.type != "cuda":
            return 0.0
        name = torch.cuda.get_device_name(device)
    for key, peak in PEAK_TFLOPS_BF16.items():
        if key.lower() in name.lower():
            return peak
    return 0.0
