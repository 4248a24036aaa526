"""Plain PyTorch reference of the speaker tower behind SIM: WavLM-Large, then ECAPA-TDNN, in float32.

It reads the published state-dict layout of ``wavlm_large_finetune.pth``
(UniSpeech's speaker-verification recipe, ``ECAPA_TDNN_SMALL(feat_dim=1024,
feat_type='wavlm_large')``) by its own key names: WavLM in microsoft's
layout under ``feature_extract.model.``, ECAPA-TDNN at the top level,
``feature_weight``.  One utterance a call, at its exact length: no
batching, no padding, no masks, no graphs.  Dense attention, exact GELU,
TF32 off for matmuls and cuDNN.  It imports nothing of the program.

    wav -> 7 strided convs (each conv, LayerNorm over channels, GELU)
        -> LayerNorm -> projection to d_model
        -> + GELU(weight-normed grouped conv, k 128, 16 groups, pad 64, last frame dropped)
        -> 24 pre-LN layers: x += attn(LN x); x += fc2(GELU(fc1(LN x)))
           scores = q k^T / sqrt(64) + gate * bias[h, i, j], where bias is
           layer 0's table of 320 T5 log buckets (max distance 800) x 16 heads,
           shared by every layer, and the gate is read per head and query from
           that head's 64-wide slice of the attention input x_h:
           g_a, g_b = sigmoid(sum over 4 of (W x_h + b) in two halves),
           gate = g_a (g_b grep_a[h] - 1) + 2
        -> 25 hidden states: each layer's input, and the final LN's output
    feats = InstanceNorm(sum_l softmax(feature_weight)_l hidden_l + 1e-6)
        -> Conv1dReluBn(k 5) -> 3 SE-Res2 blocks (scale 8, k 3, dilations 2/3/4)
        -> ReLU(1x1 conv over their concatenation, 1536)
        -> attentive statistics pooling -> BatchNorm -> linear to 256

Departures from the published code:

- A waveform shorter than 800 samples is zero-padded to 800, as the
  program does (the published conv stack needs 400 and would fail).
- No per-utterance layer norm of the waveform: s3prl's WavLM expert applies
  one when the checkpoint's ``cfg.normalize`` is set; the program does not,
  and neither does this reference (to be settled when the published file is
  in the repository).
- Dropout, layer drop and feature masking are left out (eval mode);
  BatchNorm runs on its running statistics.
- ``gate`` False fixes the gate at 1 (a control); ``formats`` puts a stage's
  products in TF32 (a control); neither is published behaviour.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

PREFIX = "feature_extract.model."
MIN_SAMPLES = 800
STAGES = ("feature_encoder", "positional_conv", "transformer", "ecapa")
FORMATS = ("f32", "tf32")


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for float32 matmuls and cuDNN convolutions inside the block (on), or off."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def relative_position_buckets(t: int, num_buckets: int, max_distance: int, device) -> torch.Tensor:
    """WavLM's ``_relative_positions_bucket`` (bidirectional T5 log buckets) of a (t, t) grid."""
    pos = torch.arange(t, dtype=torch.long, device=device)
    rel = pos[None, :] - pos[:, None]  # memory - context
    num_buckets //= 2
    buckets = (rel > 0).to(torch.long) * num_buckets
    rel = torch.abs(rel)
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(rel.float() / max_exact) / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).to(torch.long)
    large = torch.minimum(large, torch.full_like(large, num_buckets - 1))
    return buckets + torch.where(rel < max_exact, rel, large)


class ReferenceSpeaker:
    """The tower on a published-layout state dict ``sd`` and the sizes ``arch``
    (a configuration's ``wavlm_ecapa``).  ``formats``: {stage: "f32" | "tf32"}
    (default every stage f32); ``gate``: False fixes the gate at 1."""

    def __init__(self, sd: Dict[str, torch.Tensor], arch: dict, formats: Optional[Dict[str, str]] = None,
                 gate: bool = True):
        self.sd, self.a, self.gate = sd, arch, gate
        self.formats = {s: "f32" for s in STAGES}
        self.formats.update(formats or {})
        bad = {k: v for k, v in self.formats.items() if k not in STAGES or v not in FORMATS}
        if bad:
            raise ValueError(f"unknown stages or formats {bad}")
        g, v = sd[PREFIX + "encoder.pos_conv.0.weight_g"], sd[PREFIX + "encoder.pos_conv.0.weight_v"]
        # torch.nn.utils.weight_norm(conv, name="weight", dim=2): one norm a tap
        self.pos_w = g * v / torch.linalg.vector_norm(v, dim=(0, 1), keepdim=True)

    def w(self, key: str) -> torch.Tensor:
        return self.sd[PREFIX + key]

    def stage(self, name: str):
        return tf32(self.formats[name] == "tf32")

    def hidden_states(self, wav: torch.Tensor) -> List[torch.Tensor]:
        """(S,) waveform -> 25 hidden states, each (T, d_model)."""
        a, eps = self.a, self.a["layer_norm_eps"]
        with self.stage("feature_encoder"):
            x = wav[None, None, :]
            for i, s in enumerate(a["conv_strides"]):
                key = f"feature_extractor.conv_layers.{i}"
                x = F.conv1d(x, self.w(f"{key}.0.weight"), self.w(f"{key}.0.bias"), stride=s)
                x = F.layer_norm(x.transpose(1, 2), (x.shape[1],), self.w(f"{key}.2.1.weight"),
                                 self.w(f"{key}.2.1.bias"), eps).transpose(1, 2)
                x = F.gelu(x)
            x = F.layer_norm(x[0].T, (x.shape[1],), self.w("layer_norm.weight"), self.w("layer_norm.bias"), eps)
            x = F.linear(x, self.w("post_extract_proj.weight"), self.w("post_extract_proj.bias"))
        with self.stage("positional_conv"):
            k = a["pos_conv_kernel"]
            y = F.conv1d(x.T[None], self.pos_w, self.w("encoder.pos_conv.0.bias"), padding=k // 2,
                         groups=a["pos_conv_groups"])
            if k % 2 == 0:
                y = y[:, :, :-1]
            x = x + F.gelu(y[0].T)
        t, h = x.shape[0], a["heads"]
        with self.stage("transformer"):
            buckets = relative_position_buckets(t, a["rel_pos_buckets"], a["rel_pos_max_distance"], x.device)
            bias = self.w("encoder.layers.0.self_attn.relative_attention_bias.weight")[buckets].permute(2, 0, 1)
            hidden = []
            for i in range(a["layers"]):
                hidden.append(x)
                lp = f"encoder.layers.{i}"
                x = x + self.attention(lp, self.ln(f"{lp}.self_attn_layer_norm", x), bias)
                y = self.ln(f"{lp}.final_layer_norm", x)
                y = F.linear(F.gelu(F.linear(y, self.w(f"{lp}.fc1.weight"), self.w(f"{lp}.fc1.bias"))),
                             self.w(f"{lp}.fc2.weight"), self.w(f"{lp}.fc2.bias"))
                x = x + y
            hidden.append(self.ln("encoder.layer_norm", x))
        return hidden

    def ln(self, key: str, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.w(f"{key}.weight"), self.w(f"{key}.bias"),
                            self.a["layer_norm_eps"])

    def attention(self, lp: str, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        t, d = x.shape
        h = self.a["heads"]
        hd = d // h

        def proj(name):
            return F.linear(x, self.w(f"{lp}.self_attn.{name}.weight"), self.w(f"{lp}.self_attn.{name}.bias"))

        q, k, v = (proj(n).view(t, h, hd).transpose(0, 1) for n in ("q_proj", "k_proj", "v_proj"))
        scores = (q * hd ** -0.5) @ k.transpose(1, 2)  # (H, T, T)
        if self.gate:
            xh = x.view(t, h, hd).transpose(0, 1)  # (H, T, hd): the attention input, not q
            r = F.linear(xh, self.w(f"{lp}.self_attn.grep_linear.weight"), self.w(f"{lp}.self_attn.grep_linear.bias"))
            g_a, g_b = torch.sigmoid(r.view(h, t, 2, 4).sum(-1)).chunk(2, dim=-1)  # (H, T, 1) each
            gate = g_a * (g_b * self.w(f"{lp}.self_attn.grep_a").view(h, 1, 1) - 1.0) + 2.0
        else:
            gate = 1.0
        attn = torch.softmax(scores + gate * bias, dim=-1)
        out = (attn @ v).transpose(0, 1).reshape(t, d)
        return F.linear(out, self.w(f"{lp}.self_attn.out_proj.weight"), self.w(f"{lp}.self_attn.out_proj.bias"))

    # -- ECAPA-TDNN (channels first, (C, T)) ---------------------------------

    def conv(self, key: str, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
        """``nn.Conv1d`` with 'same' padding, (C, T) -> (C', T)."""
        w = self.sd[f"{key}.weight"]
        pad = (w.shape[-1] - 1) * dilation // 2
        return F.conv1d(x[None], w, self.sd[f"{key}.bias"], padding=pad, dilation=dilation)[0]

    def bn(self, key: str, x: torch.Tensor) -> torch.Tensor:
        sd = self.sd
        return F.batch_norm(x[None], sd[f"{key}.running_mean"], sd[f"{key}.running_var"], sd[f"{key}.weight"],
                            sd[f"{key}.bias"], training=False, eps=1e-5)[0]

    def conv_relu_bn(self, key: str, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
        return self.bn(f"{key}.bn", F.relu(self.conv(f"{key}.conv", x, dilation)))

    def se_res2_block(self, key: str, x: torch.Tensor, dilation: int) -> torch.Tensor:
        s = self.a["ecapa_scale"]
        y = self.conv_relu_bn(f"{key}.Conv1dReluBn1", x)
        parts, out, sp = torch.split(y, y.shape[0] // s, dim=0), [], None
        for i in range(s - 1):
            sp = parts[i] if i == 0 else sp + parts[i]
            sp = self.conv(f"{key}.Res2Conv1dReluBn.convs.{i}", sp, dilation)
            sp = self.bn(f"{key}.Res2Conv1dReluBn.bns.{i}", F.relu(sp))
            out.append(sp)
        y = self.conv_relu_bn(f"{key}.Conv1dReluBn2", torch.cat(out + [parts[s - 1]], dim=0))
        se = F.relu(F.linear(y.mean(dim=1), self.sd[f"{key}.SE_Connect.linear1.weight"],
                             self.sd[f"{key}.SE_Connect.linear1.bias"]))
        se = torch.sigmoid(F.linear(se, self.sd[f"{key}.SE_Connect.linear2.weight"],
                                    self.sd[f"{key}.SE_Connect.linear2.bias"]))
        return y * se[:, None] + x

    def ecapa(self, hidden: List[torch.Tensor]) -> torch.Tensor:
        """The 25 hidden states -> the (256,) embedding."""
        with self.stage("ecapa"):
            wts = torch.softmax(self.sd["feature_weight"], dim=-1)
            x = (wts[:, None, None] * torch.stack(hidden)).sum(dim=0).T + 1e-6  # (C, T)
            x = F.instance_norm(x[None], eps=1e-5)[0]
            out = [self.conv_relu_bn("layer1", x)]
            for b, dil in enumerate(self.a["ecapa_dilations"]):
                out.append(self.se_res2_block(f"layer{b + 2}", out[-1], dil))
            x = F.relu(self.conv("conv", torch.cat(out[1:], dim=0)))
            alpha = torch.softmax(self.conv("pooling.linear2", torch.tanh(self.conv("pooling.linear1", x))), dim=1)
            mean = (alpha * x).sum(dim=1)
            std = torch.sqrt(((alpha * x ** 2).sum(dim=1) - mean ** 2).clamp(min=1e-9))
            pooled = self.bn("bn", torch.cat([mean, std])[:, None])[:, 0]
            return F.linear(pooled, self.sd["linear.weight"], self.sd["linear.bias"])

    @torch.no_grad()
    def embed(self, wav: np.ndarray) -> np.ndarray:
        """One waveform (16 kHz) at its exact length -> its (256,) float32 embedding."""
        device = self.pos_w.device
        x = torch.as_tensor(np.asarray(wav, np.float32).reshape(-1), device=device)
        if x.shape[0] < MIN_SAMPLES:
            x = F.pad(x, (0, MIN_SAMPLES - x.shape[0]))
        return self.ecapa(self.hidden_states(x)).cpu().numpy()
