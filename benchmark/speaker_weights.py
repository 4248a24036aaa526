"""Seeded weights of the speaker tower, made on the device, in the published state-dict layout.

The layout is that of ``wavlm_large_finetune.pth`` (UniSpeech's speaker
verification recipe, ``ECAPA_TDNN_SMALL(feat_dim=1024,
feat_type='wavlm_large')``): WavLM in microsoft's layout under
``feature_extract.model.`` (the positional conv weight-normed as
``weight_g`` / ``weight_v``), ECAPA-TDNN at the top level, and
``feature_weight``.  BatchNorm's ``num_batches_tracked`` is left out: the
forward pass reads no such tensor.

One ``randn`` call draws every tensor from a ``torch.Generator`` seeded with
``--seed`` on the device; each tensor is a slice of that buffer, scaled in
place.  The draws (the configuration file states them under ``assumed``):

- weights of linears and convolutions: N(0, 1 / fan_in);
- biases, LayerNorm and BatchNorm shifts, BatchNorm running means:
  N(0, 0.1^2); LayerNorm and BatchNorm scales, the gate's ``grep_a``:
  1 + N(0, 0.1^2); BatchNorm running variances 1 + U(0, 0.5) (a normal
  draw through its own CDF);
- the positional conv's ``weight_g``: sqrt(d_model / kernel) (1 + N(0,
  0.1^2)), so that the folded weight is about N(0, 1 / fan_in);
- ``feature_weight`` and the relative-position bias table: N(0, 1), so that
  the bias moves the softmax as a trained table does.

It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

SEED_MASK = (1 << 63) - 1
WAVLM_PREFIX = "feature_extract.model."

Spec = Tuple[str, tuple, str, float]  # key, shape, kind, fan_in (or the scale of a "g")


def _ln(key: str, c: int) -> List[Spec]:
    return [(f"{key}.weight", (c,), "scale", 0), (f"{key}.bias", (c,), "shift", 0)]


def _bn(key: str, c: int) -> List[Spec]:
    return _ln(key, c) + [(f"{key}.running_mean", (c,), "shift", 0), (f"{key}.running_var", (c,), "var", 0)]


def _lin(key: str, cout: int, cin: int, k: int = None) -> List[Spec]:
    shape = (cout, cin) if k is None else (cout, cin, k)
    return [(f"{key}.weight", shape, "w", cin * (k or 1)), (f"{key}.bias", (cout,), "shift", 0)]


def wavlm_specs(a: dict, prefix: str = WAVLM_PREFIX) -> List[Spec]:
    d, f, h = a["d_model"], a["ffn"], a["heads"]
    specs, cin = [], 1
    for i, (c, k) in enumerate(zip(a["conv_dims"], a["conv_kernels"])):
        specs += _lin(f"{prefix}feature_extractor.conv_layers.{i}.0", c, cin, k)
        specs += _ln(f"{prefix}feature_extractor.conv_layers.{i}.2.1", c)
        cin = c
    specs += _ln(f"{prefix}layer_norm", cin) + _lin(f"{prefix}post_extract_proj", d, cin)
    k, g = a["pos_conv_kernel"], a["pos_conv_groups"]
    specs += [(f"{prefix}encoder.pos_conv.0.weight_g", (1, 1, k), "g", math.sqrt(d / k)),
              (f"{prefix}encoder.pos_conv.0.weight_v", (d, d // g, k), "w", d // g * k),
              (f"{prefix}encoder.pos_conv.0.bias", (d,), "shift", 0)]
    for i in range(a["layers"]):
        lp = f"{prefix}encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            specs += _lin(f"{lp}.self_attn.{name}", d, d)
        specs += _lin(f"{lp}.self_attn.grep_linear", a["gate_proj"], d // h)
        specs += [(f"{lp}.self_attn.grep_a", (1, h, 1, 1), "scale", 0)]
        if i == 0:
            specs += [(f"{lp}.self_attn.relative_attention_bias.weight", (a["rel_pos_buckets"], h), "unit", 0)]
        specs += _ln(f"{lp}.self_attn_layer_norm", d) + _lin(f"{lp}.fc1", f, d) + _lin(f"{lp}.fc2", d, f)
        specs += _ln(f"{lp}.final_layer_norm", d)
    return specs + _ln(f"{prefix}encoder.layer_norm", d)


def ecapa_specs(a: dict) -> List[Spec]:
    c, s, d = a["ecapa_channels"], a["ecapa_scale"], a["d_model"]
    specs = _lin("layer1.conv", c, d, a["ecapa_layer1_kernel"]) + _bn("layer1.bn", c)
    for b in range(2, 2 + len(a["ecapa_dilations"])):
        key = f"layer{b}"
        specs += _lin(f"{key}.Conv1dReluBn1.conv", c, c, 1) + _bn(f"{key}.Conv1dReluBn1.bn", c)
        for i in range(s - 1):
            specs += _lin(f"{key}.Res2Conv1dReluBn.convs.{i}", c // s, c // s, a["ecapa_res2_kernel"])
        for i in range(s - 1):
            specs += _bn(f"{key}.Res2Conv1dReluBn.bns.{i}", c // s)
        specs += _lin(f"{key}.Conv1dReluBn2.conv", c, c, 1) + _bn(f"{key}.Conv1dReluBn2.bn", c)
        specs += _lin(f"{key}.SE_Connect.linear1", a["ecapa_se_channels"], c)
        specs += _lin(f"{key}.SE_Connect.linear2", c, a["ecapa_se_channels"])
    m = a["ecapa_mfa_channels"]
    specs += _lin("conv", m, c * len(a["ecapa_dilations"]), 1)
    specs += _lin("pooling.linear1", a["ecapa_attention_channels"], m, 1)
    specs += _lin("pooling.linear2", m, a["ecapa_attention_channels"], 1)
    return specs + _bn("bn", 2 * m) + _lin("linear", a["embedding_dim"], 2 * m)


def param_specs(a: dict) -> List[Spec]:
    """(key, shape, kind, fan_in) of every tensor of the state dict, in a fixed order."""
    return wavlm_specs(a) + ecapa_specs(a) + [("feature_weight", (a["layers"] + 1,), "unit", 0)]


def make_state(a: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seed's float32 state dict on ``device``: views into one buffer."""
    specs = param_specs(a)
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed & SEED_MASK)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    state, offset = {}, 0
    with torch.no_grad():
        for (key, shape, kind, fan_in), n in zip(specs, sizes):
            t = flat[offset: offset + n].view(shape)
            offset += n
            if kind == "w":
                t.mul_(1.0 / math.sqrt(fan_in))
            elif kind == "shift":
                t.mul_(0.1)
            elif kind == "scale":
                t.mul_(0.1).add_(1.0)
            elif kind == "g":
                t.mul_(0.1).add_(1.0).mul_(fan_in)
            elif kind == "var":  # 1 + U(0, 0.5): the normal draw through its CDF
                t.copy_(1.0 + 0.25 * (1.0 + torch.erf(t / math.sqrt(2.0))))
            state[key] = t
    return state


def parameter_count(a: dict) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in param_specs(a))
