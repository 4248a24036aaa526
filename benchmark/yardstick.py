"""The benchmark's yardstick: FLOPs ledger, peaks, kernel bounds, kernel groups.

Frozen copies, so that no change to the program moves them:

- ``ledger`` is ``simwhisper_codec_tpu_torch/utils/flops.py::codec_flops``
  with the decoder transformer and the Vocos ConvNeXt blocks each split into
  the part that a configuration may run in int8 (the FFN, the pointwise
  chain) and the rest; the components sum to the original total (1.317
  TFLOP per 30 s chunk and row at the published widths).
- ``ffn_call_bound_s`` is ``chip_smoke.py`` phase 2's operations and bytes
  of one B2 / B3 call (LN-FFN kernels), from its rows and widths.
- ``KERNEL_GROUPS`` is ``tools/profile_torch_port.py``'s ``GROUPS``: the
  device-function name fragments of each hand kernel's passes.

Peaks are NVIDIA's data-sheet figures for one H100 SXM at 700 W, dense.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAK_OPS_PER_S = {
    "bf16": 989.4e12,
    "int8": 1979e12,
    "tf32": 494.7e12,
    "f32": 67e12,
}
BYTES_PER_S = 3.35e12

KERNEL_GROUPS = {
    "B1": ("::pflash_sm90_kernel<",),
    "B2": ("::ln_ffn_bf16_rows_kernel<", "::ln_ffn_bf16_up_kernel<", "::ln_ffn_bf16_down_kernel<"),
    "B3": ("::ln_ffn_int8_rows_kernel<", "::ln_ffn_int8_upmax_kernel<", "::ln_ffn_int8_upq_kernel<",
           "::ln_ffn_int8_down_kernel<"),
    "B4": ("::convnext_dw_rows_kernel<", "::convnext_dw_up_kernel<", "::convnext_dw_down_kernel<"),
    "B5": ("::flash_sm90_kernel<",),
}
# launch-count key (before ":<C>x<I>") of each LN-FFN kernel -> (group, operand dtype)
FFN_LAUNCH_KEYS = {"ln_ffn_bf16": ("B2", "bf16"), "ln_ffn_int8": ("B3", "int8")}


def in_group(kernel_name: str, group: str) -> bool:
    return any(f in kernel_name for f in KERNEL_GROUPS[group])


def _transformer_parts(t: int, d: int, f: int, layers: int) -> Tuple[int, int]:
    """(attention: QKVO projections + scores / AV, FFN: two matmuls) of a layer stack."""
    return layers * (8 * t * d * d + 4 * t * t * d), layers * 4 * t * d * f


def _resunit_stack_flops(t: int, c: int, n_units: int = 3, k: int = 7, resample_k: int = 12) -> int:
    conv7 = 2 * t * k * c * c
    conv1 = 2 * t * c * c
    resample = 2 * (2 * (2 * t) * (resample_k // 2) * c)
    return n_units * (conv7 + conv1 + resample)


def ledger(gp: dict) -> Dict[str, int]:
    """FLOPs per 30 s chunk and row, by component, of the generator params ``gp``
    (multiply-adds count 2; elementwise work is left out, as in the original)."""
    fe, enc, dec = gp["feature_extractor"], gp["acoustic_encoder"], gp["acoustic_decoder"]
    down, v = gp["downsample"], gp["vocos"]
    t_mel = fe["nb_max_frames"]
    n_fft = fe["n_fft"]
    n_freq = n_fft // 2 + 1
    n_mels = fe["feature_size"]
    d = enc["d_model"]
    t_enc = t_mel // 2
    s = down["stack_factor"]
    t_lat = t_enc // s
    h_dim, lat = down["hidden_dim"], down["latent_dim"]
    enc_attn, enc_ffn = _transformer_parts(t_enc, d, enc["encoder_ffn_dim"], enc["encoder_layers"])
    dec_attn, dec_ffn = _transformer_parts(t_enc, d, dec["decoder_ffn_dim"], dec["decoder_layers"])
    return {
        "mel_dft": 2 * t_mel * n_fft * (2 * n_freq),
        "mel_filterbank": 2 * t_mel * n_freq * n_mels,
        "encoder_convs": 2 * t_mel * 3 * n_mels * d + 2 * t_enc * 3 * d * d,
        "encoder_transformer": enc_attn + enc_ffn,
        "downsample": 2 * t_lat * (d * s) * h_dim + _resunit_stack_flops(t_lat, h_dim) + 2 * t_lat * h_dim * lat,
        "upsample": 2 * t_lat * lat * h_dim + _resunit_stack_flops(t_lat, h_dim) + 2 * t_lat * h_dim * (d * s),
        "decoder_attention": dec_attn,
        "decoder_ffn": dec_ffn,
        "decoder_deconvs": 2 * t_mel * 3 * d * d + 2 * t_mel * 3 * d * n_mels,
        "vocos_embed": 2 * t_mel * 7 * v["input_channels"] * v["dim"],
        "vocos_depthwise": v["num_layers"] * 2 * t_mel * 7 * v["dim"],
        "vocos_pointwise": v["num_layers"] * 4 * t_mel * v["dim"] * v["intermediate_dim"],
        "vocos_head": 2 * t_mel * v["dim"] * (v["n_fft"] + 2),
        "istft": 2 * 2 * t_mel * (v["n_fft"] // 2 + 1) * v["n_fft"],
    }


def chunk_seconds(gp: dict) -> float:
    fe = gp["feature_extractor"]
    return fe["n_samples"] / fe["sampling_rate"]


def least_seconds_per_audio_second(gp: dict, precision: Dict[str, str]) -> float:
    """The least device seconds one input audio second's ledger FLOPs can take:
    each component over the peak of the precision ``precision`` gives it."""
    per_chunk = sum(flops / PEAK_OPS_PER_S[precision[name]] for name, flops in ledger(gp).items())
    return per_chunk / chunk_seconds(gp)


def ffn_call_bound_s(kind: str, m: int, c: int, inter: int, separate_residual: bool) -> float:
    """The least time of one LN-FFN call over ``m`` rows of width ``c`` and
    hidden width ``inter``: the larger of its operations over the peak of its
    operand type and the bytes it must move over 3.35 TB/s (each input read
    once, the output written once; bf16 activations, weights as the kernel
    reads them)."""
    act_bytes = (3 if separate_residual else 2) * m * c * 2
    ops = 4.0 * m * c * inter
    if kind == "bf16":
        nbytes = act_bytes + 2 * c * inter * 2 + (2 * c + inter) * 2
    elif kind == "int8":
        nbytes = act_bytes + 2 * c * inter + (inter + c) * 4 + (2 * c + inter) * 2
    else:
        raise ValueError(kind)
    return max(ops / PEAK_OPS_PER_S[kind], nbytes / BYTES_PER_S)


def ffn_rows(gp: dict, direction: str, batch: int, frames: int, c: int, inter: int) -> Tuple[int, bool]:
    """(rows, separate residual) of an LN-FFN call of width ``c`` x ``inter``
    inside one call of a serving program over ``batch`` rows: ``frames`` is
    the program input's time axis (samples for ``tokenize``, code frames for
    ``detokenize``)."""
    enc, dec, down, v = gp["acoustic_encoder"], gp["acoustic_decoder"], gp["downsample"], gp["vocos"]
    hop = gp["feature_extractor"]["hop_length"]
    if direction == "tokenize":
        t_tr = frames // hop // enc["stride_size"]
        shapes = {(enc["d_model"], enc["encoder_ffn_dim"]): (batch * t_tr, False)}
    else:
        t_tr = frames * down["stack_factor"]
        shapes = {(dec["d_model"], dec["decoder_ffn_dim"]): (batch * t_tr, False),
                  (v["dim"], v["intermediate_dim"]): (batch * t_tr * dec["stride_size"], True)}
    if (c, inter) not in shapes:
        raise KeyError(f"no {c}x{inter} LN-FFN call in {direction}")
    return shapes[(c, inter)]


def parse_ffn_key(key: str):
    """A launch-count key ``ln_ffn_int8:512x4096`` -> (group, dtype, c, inter), or None."""
    name, _, shape = key.partition(":")
    if name not in FFN_LAUNCH_KEYS or "x" not in shape:
        return None
    c, inter = (int(v) for v in shape.split("x"))
    return (*FFN_LAUNCH_KEYS[name], c, inter)
