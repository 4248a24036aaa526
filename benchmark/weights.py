"""Seeded weights of the codec, made on the device, under the upstream state-dict keys.

One ``randn`` call draws every parameter from a ``torch.Generator`` seeded
with ``--seed`` on the device; each tensor is then a slice of that buffer,
scaled in place.  The draws (the configuration files state them under
``assumed``):

- weights of linears and convolutions: N(0, 1 / fan_in), so that every
  layer keeps unit-scale activations; the attention's q and k projections
  1.5x wider, so that scores spread (std about 2.25) and each query picks a
  few keys;
- biases, LayerNorm shifts and the SnakeBeta log-parameters: N(0, 0.1^2);
  LayerNorm scales 1 + N(0, 0.1^2);
- the Vocos layer scale gamma: 0.35 + N(0, 0.05^2), so that the 24
  ConvNeXt updates together are about as large as the embedding they add to.

Random weights are enough for speed and for agreement with the reference;
these keep every stage's contribution to the output well above rounding.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

SEED_MASK = (1 << 63) - 1


def _transformer(prefix: str, d: int, f: int, layers: int) -> List[Tuple[str, tuple, str, float]]:
    specs = []
    for i in range(layers):
        k = f"{prefix}.layers.{i}"
        specs += [(f"{k}.self_attn_layer_norm.weight", (d,), "scale", 0), (f"{k}.self_attn_layer_norm.bias", (d,), "shift", 0),
                  (f"{k}.self_attn.q_proj.weight", (d, d), "qk", d), (f"{k}.self_attn.q_proj.bias", (d,), "shift", 0),
                  (f"{k}.self_attn.k_proj.weight", (d, d), "qk", d),
                  (f"{k}.self_attn.v_proj.weight", (d, d), "w", d), (f"{k}.self_attn.v_proj.bias", (d,), "shift", 0),
                  (f"{k}.self_attn.out_proj.weight", (d, d), "w", d), (f"{k}.self_attn.out_proj.bias", (d,), "shift", 0),
                  (f"{k}.final_layer_norm.weight", (d,), "scale", 0), (f"{k}.final_layer_norm.bias", (d,), "shift", 0),
                  (f"{k}.fc1.weight", (f, d), "w", d), (f"{k}.fc1.bias", (f,), "shift", 0),
                  (f"{k}.fc2.weight", (d, f), "w", f), (f"{k}.fc2.bias", (d,), "shift", 0)]
    return specs + [(f"{prefix}.layer_norm.weight", (d,), "scale", 0), (f"{prefix}.layer_norm.bias", (d,), "shift", 0)]


def _res_units(prefix: str, h: int, n: int):
    specs = []
    for j in range(n):
        k = f"{prefix}.res_blocks.{j}.block"
        specs += [(f"{k}.0.act.alpha", (h,), "shift", 0), (f"{k}.0.act.beta", (h,), "shift", 0),
                  (f"{k}.1.weight", (h, h, 7), "w", h * 7), (f"{k}.1.bias", (h,), "shift", 0),
                  (f"{k}.2.act.alpha", (h,), "shift", 0), (f"{k}.2.act.beta", (h,), "shift", 0),
                  (f"{k}.3.weight", (h, h, 1), "w", h), (f"{k}.3.bias", (h,), "shift", 0)]
    return specs


def param_specs(gp: dict) -> List[Tuple[str, tuple, str, float]]:
    """(key, shape, kind, fan_in) of every parameter, in a fixed order."""
    fe, enc, dec = gp["feature_extractor"], gp["acoustic_encoder"], gp["acoustic_decoder"]
    down, up, v = gp["downsample"], gp["upsample"], gp["vocos"]
    n_mels, d = fe["feature_size"], enc["d_model"]
    specs = [("acoustic_encoder.conv1.weight", (d, n_mels, 3), "w", n_mels * 3),
             ("acoustic_encoder.conv1.bias", (d,), "shift", 0),
             ("acoustic_encoder.conv2.weight", (d, d, 3), "w", d * 3),
             ("acoustic_encoder.conv2.bias", (d,), "shift", 0)]
    specs += _transformer("acoustic_encoder", d, enc["encoder_ffn_dim"], enc["encoder_layers"])
    h, s = down["hidden_dim"], down["stack_factor"]
    n_units = len(down.get("dilations", (1, 3, 9)))
    specs += [("downsample.in_proj.weight", (h, down["in_dim"] * s, 1), "w", down["in_dim"] * s),
              ("downsample.in_proj.bias", (h,), "shift", 0)]
    specs += _res_units("downsample", h, n_units)
    specs += [("downsample.to_latent.weight", (down["latent_dim"], h, 1), "w", h),
              ("downsample.to_latent.bias", (down["latent_dim"],), "shift", 0)]
    h, s = up["hidden_dim"], up["stack_factor"]
    specs += [("upsample.from_latent.weight", (h, up["latent_dim"], 1), "w", up["latent_dim"]),
              ("upsample.from_latent.bias", (h,), "shift", 0)]
    specs += _res_units("upsample", h, len(up.get("dilations", (1, 3, 9))))
    specs += [("upsample.to_stacked.weight", (up["out_dim"] * s, h, 1), "w", h),
              ("upsample.to_stacked.bias", (up["out_dim"] * s,), "shift", 0)]
    dd = dec["d_model"]
    specs += _transformer("acoustic_decoder", dd, dec["decoder_ffn_dim"], dec["decoder_layers"])
    specs += [("acoustic_decoder.deconv1.weight", (dd, dd, 3), "w", dd * 3),
              ("acoustic_decoder.deconv1.bias", (dd,), "shift", 0),
              ("acoustic_decoder.deconv2.weight", (dd, dec["num_mel_bins"], 3), "w", dd * 3),
              ("acoustic_decoder.deconv2.bias", (dec["num_mel_bins"],), "shift", 0)]
    c, inter = v["dim"], v["intermediate_dim"]
    specs += [("vocos.backbone.embed.weight", (c, v["input_channels"], 7), "w", v["input_channels"] * 7),
              ("vocos.backbone.embed.bias", (c,), "shift", 0),
              ("vocos.backbone.norm.weight", (c,), "scale", 0), ("vocos.backbone.norm.bias", (c,), "shift", 0)]
    for i in range(v["num_layers"]):
        k = f"vocos.backbone.convnext.{i}"
        specs += [(f"{k}.gamma", (c,), "gamma", 0),
                  (f"{k}.dwconv.weight", (c, 1, 7), "w", 7), (f"{k}.dwconv.bias", (c,), "shift", 0),
                  (f"{k}.norm.weight", (c,), "scale", 0), (f"{k}.norm.bias", (c,), "shift", 0),
                  (f"{k}.pwconv1.weight", (inter, c), "w", c), (f"{k}.pwconv1.bias", (inter,), "shift", 0),
                  (f"{k}.pwconv2.weight", (c, inter), "w", inter), (f"{k}.pwconv2.bias", (c,), "shift", 0)]
    specs += [("vocos.backbone.final_layer_norm.weight", (c,), "scale", 0),
              ("vocos.backbone.final_layer_norm.bias", (c,), "shift", 0),
              ("vocos.head.out.weight", (v["n_fft"] + 2, c), "w", c),
              ("vocos.head.out.bias", (v["n_fft"] + 2,), "shift", 0)]
    return specs


def make_state(gp: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seed's float32 weights on ``device``: views into one buffer."""
    specs = param_specs(gp)
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed & SEED_MASK)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    state, offset = {}, 0
    with torch.no_grad():
        for (key, shape, kind, fan_in), n in zip(specs, sizes):
            t = flat[offset: offset + n].view(shape)
            offset += n
            if kind in ("w", "qk"):
                t.mul_((1.5 if kind == "qk" else 1.0) / math.sqrt(fan_in))
            elif kind == "shift":
                t.mul_(0.1)
            elif kind == "scale":
                t.mul_(0.1).add_(1.0)
            elif kind == "gamma":
                t.mul_(0.05).add_(0.35)
            state[key] = t
    return state


def parameter_count(gp: dict) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in param_specs(gp))
