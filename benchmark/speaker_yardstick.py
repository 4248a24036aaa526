"""The speaker tower's yardstick: the FLOPs of one utterance at its exact length, and the f32 peak.

An operation is a multiply or an add of a matrix product or a convolution
(2 a multiply-accumulate); norms, activations, softmax and the gate's
elementwise work are left out.  Per utterance of ``n`` samples (shorter
than 800: counted as 800, as the program pads it):

- the conv stack: each layer's output frames x Cout x Cin x K x 2;
- the feature projection and the positional conv (grouped: Cin / groups a
  filter), each frame;
- each of the 24 layers: q, k, v, o and the FFN (8 d^2 + 4 d f a frame),
  the gate's projection (2 x 64 x 8 a head and frame) and attention
  (4 T d a frame: q k^T and the product with v);
- the weighted sum of the 25 hidden states (2 x 25 x d a frame);
- ECAPA: the k 5 conv, each block's two 1x1 convs, its 7 Res2 convs and its
  squeeze-excitation, the 1x1 conv over the concatenation, the pooling's
  two 1x1 convs, and the final linear.

``F32_PEAK``: the H100 SXM's float32 rate outside the tensor cores, 132 SMs
x 128 lanes x 2 x 1.98 GHz.  It imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict

F32_PEAK = 132 * 128 * 2 * 1.98e9  # 66.9 TFLOP/s
MIN_SAMPLES = 800


def frames(a: dict, n: int):
    """Output frames of each conv layer for ``n`` samples."""
    out = []
    for k, s in zip(a["conv_kernels"], a["conv_strides"]):
        n = (n - k) // s + 1
        out.append(n)
    return out


def utterance_flops(a: dict, n: int) -> Dict[str, int]:
    """FLOPs by part of one utterance of ``n`` samples at its exact length."""
    n = max(int(n), MIN_SAMPLES)
    ts = frames(a, n)
    t, d, f, h = ts[-1], a["d_model"], a["ffn"], a["heads"]
    conv, cin = 0, 1
    for tt, c, k in zip(ts, a["conv_dims"], a["conv_kernels"]):
        conv += 2 * tt * c * cin * k
        cin = c
    c, s, m = a["ecapa_channels"], a["ecapa_scale"], a["ecapa_mfa_channels"]
    blocks = len(a["ecapa_dilations"])
    block = (2 * 2 * c * c + (s - 1) * 2 * (c // s) ** 2 * a["ecapa_res2_kernel"]) * t \
        + 2 * 2 * c * a["ecapa_se_channels"]
    ecapa = (2 * d * c * a["ecapa_layer1_kernel"] * t + blocks * block + 2 * m * blocks * c * t
             + 2 * 2 * m * a["ecapa_attention_channels"] * t + 2 * 2 * m * a["embedding_dim"])
    return {
        "conv_stack": conv,
        "projection": 2 * t * cin * d,
        "positional_conv": 2 * t * d * (d // a["pos_conv_groups"]) * a["pos_conv_kernel"],
        "linears": a["layers"] * t * (8 * d * d + 4 * d * f + 2 * d * a["gate_proj"]),
        "attention": a["layers"] * 4 * t * t * d,
        "weighted_sum": 2 * (a["layers"] + 1) * t * d,
        "ecapa": ecapa,
    }


def utterance_total(a: dict, n: int) -> int:
    return sum(utterance_flops(a, n).values())
