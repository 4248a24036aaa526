"""Self-supervised speech towers (wav2vec 2.0 / HuBERT / WavLM).

Counterpart of ``simwhisper_codec_tpu/models/ssl.py``: the strided conv
feature encoder, the feature projection, the conv positional embedding and
the transformer stack (post-LN base, pre-LN large, WavLM's gated relative
position bias) that the three metric towers share: UTMOS's wav2vec2-base,
speaker similarity's WavLM-large and the WER's HuBERT-large CTC.

Parameters are a tree of dicts of tensors with the JAX tree's key names;
the layers are a list (the JAX tree stacks them for ``lax.scan``), and every
weight is in torch's layout: linears (out, in), convs (Cout, Cin/groups, K).
Attention is matmul, softmax, matmul with q pre-scaled, as the JAX function
computes it; run under ``f32_precision("highest")`` for its
``Precision.HIGHEST``.  ``utils/ssl_checkpoint.py`` converts published
state dicts into the tree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F


@dataclasses.dataclass(frozen=True)
class SSLConfig:
    d_model: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    pre_ln: bool = False  # HF do_stable_layer_norm (True for *-large)
    conv_dims: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernels: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_strides: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    extract_norm: str = "group"  # "group": GroupNorm on layer 0; "layer": LN every layer
    conv_pos_kernel: int = 128
    conv_pos_groups: int = 16
    rel_pos_bias: bool = False  # WavLM gated relative position bias
    num_buckets: int = 320
    max_distance: int = 800
    layer_norm_eps: float = 1e-5


def ssl_config_from_dict(d: dict) -> SSLConfig:
    """``dataclasses.asdict(cfg)`` (as a checkpoint may carry it) -> SSLConfig."""
    return SSLConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def wav2vec2_base_config() -> SSLConfig:
    """fairseq wav2vec2-small == HF facebook/wav2vec2-base-960h encoder shape."""
    return SSLConfig()


def hubert_base_config() -> SSLConfig:
    """HF facebook/hubert-base-ls960."""
    return SSLConfig()


def hubert_large_ft_config() -> SSLConfig:
    """HF facebook/hubert-large-ls960-ft (the reference's WER model,
    ``tools/wer/calculate_wer.py:269-374``)."""
    return SSLConfig(d_model=1024, num_layers=24, num_heads=16, ffn_dim=4096, pre_ln=True, conv_bias=True,
                     extract_norm="layer")


def wavlm_large_config() -> SSLConfig:
    """HF microsoft/wavlm-large (s3prl 'wavlm_large' upstream)."""
    return SSLConfig(d_model=1024, num_layers=24, num_heads=16, ffn_dim=4096, pre_ln=True, conv_bias=True,
                     extract_norm="layer", rel_pos_bias=True)


def power_of_two_bucket(n: int) -> int:
    """The next power-of-two multiple of one second (16000 samples) >= n: the
    towers pad one utterance a call to it and mask the padding."""
    bucket = 16000
    while bucket < n:
        bucket *= 2
    return bucket


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")  # exact erf GELU (HF "gelu")


def _layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def _linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p["w"], p["b"])


def feat_extract_output_length(cfg: SSLConfig, n_samples):
    """Samples -> feature frames through the conv stack (HF semantics)."""
    length = n_samples
    for k, s in zip(cfg.conv_kernels, cfg.conv_strides):
        length = (length - k) // s + 1
    return length


def _valid(t: int, lengths: torch.Tensor) -> torch.Tensor:
    """(B, T, 1) bool: frame < length."""
    return (torch.arange(t, device=lengths.device)[None, :] < lengths[:, None])[..., None]


def conv_feature_extractor(cfg: SSLConfig, params: dict, wav: torch.Tensor,
                           lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S) float32 -> (B, T, conv_dims[-1]) features.

    With ``lengths``, valid frames equal an exact-length run: the layer-0
    GroupNorm statistics cover valid frames only (``nn.GroupNorm`` would
    take the padding into them) and pad frames are zeroed after each layer.
    """
    x = wav[:, None, :]  # (B, 1, S): the convs run channels-first
    cur = lengths
    for i, (layer, k, s) in enumerate(zip(params["conv_layers"], cfg.conv_kernels, cfg.conv_strides)):
        x = F.conv1d(x, layer["w"], layer.get("b"), stride=s)  # (B, C, T)
        valid = None
        if cur is not None:
            cur = (cur - k) // s + 1
            valid = _valid(x.shape[-1], cur).transpose(1, 2)  # (B, 1, T)
            x = x * valid
        if cfg.extract_norm == "group" and i == 0:
            # GroupNorm with one group a channel: per-channel norm over (valid) time
            if valid is None:
                mean = x.mean(-1, keepdim=True)
                var = torch.square(x - mean).mean(-1, keepdim=True)
            else:
                cnt = torch.clamp(cur[:, None, None].to(torch.float32), min=1.0)
                mean = x.sum(-1, keepdim=True) / cnt
                var = (torch.square(x - mean) * valid).sum(-1, keepdim=True) / cnt
            x = (x - mean) * torch.rsqrt(var + cfg.layer_norm_eps)
            x = x * layer["norm_scale"][:, None] + layer["norm_bias"][:, None]
        elif cfg.extract_norm == "layer":
            x = F.layer_norm(x.transpose(1, 2), (x.shape[1],), layer["norm_scale"], layer["norm_bias"],
                             cfg.layer_norm_eps).transpose(1, 2)
        x = _gelu(x)
        if valid is not None:
            x = x * valid  # the norm's shift leaks into the pads
    return x.transpose(1, 2)


def positional_conv_embedding(cfg: SSLConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Grouped conv k=128, 16 groups, pad 64 (weight norm folded at load),
    the even kernel's extra frame trimmed, then GELU.  x: (B, T, D)."""
    y = F.conv1d(x.transpose(1, 2), params["w"], params["b"], padding=cfg.conv_pos_kernel // 2,
                 groups=cfg.conv_pos_groups)
    if cfg.conv_pos_kernel % 2 == 0:
        y = y[:, :, :-1]
    return _gelu(y.transpose(1, 2))


def relative_position_buckets(cfg: SSLConfig, t: int) -> np.ndarray:
    """WavLM / T5 log-bucketed relative positions (T, T), on the host."""
    context = np.arange(t)[:, None]
    memory = np.arange(t)[None, :]
    rel = memory - context
    num_buckets = cfg.num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * num_buckets
    rel = np.abs(rel)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    rel_large = np.log(np.maximum(rel, 1).astype(np.float64) / max_exact)
    rel_large = rel_large / math.log(cfg.max_distance / max_exact)
    rel_large = (max_exact + rel_large * (num_buckets - max_exact)).astype(np.int64)
    rel_large = np.minimum(rel_large, num_buckets - 1)
    buckets += np.where(is_small, rel, rel_large)
    return buckets


_BUCKETS: dict = {}


def _buckets_on(cfg: SSLConfig, t: int, device: torch.device) -> torch.Tensor:
    """``relative_position_buckets`` as a device tensor, cached per (T, device)."""
    key = (cfg.num_buckets, cfg.max_distance, t, str(device))
    if key not in _BUCKETS:
        _BUCKETS[key] = torch.from_numpy(relative_position_buckets(cfg, t)).to(device)
    return _BUCKETS[key]


def _attention(cfg: SSLConfig, lp: dict, x: torch.Tensor, pos_bias: Optional[torch.Tensor],
               pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Self-attention; with ``pos_bias``, WavLM's gated relative position bias."""
    b, t, d = x.shape
    h = cfg.num_heads
    hd = d // h

    def heads(y):
        return y.reshape(b, t, h, hd).transpose(1, 2)

    q = heads(_linear(lp["q"], x)) * (hd ** -0.5)
    k = heads(_linear(lp["k"], x))
    v = heads(_linear(lp["v"], x))
    scores = q @ k.transpose(-1, -2)
    if pos_bias is not None:
        # the gate reads the attention input before the q projection
        # (WavLMAttention.forward steps 1-4)
        proj = F.linear(heads(x), lp["gru_w"], lp["gru_b"])  # (B, H, T, 8)
        proj = proj.reshape(b, h, t, 2, 4).sum(-1)
        gate_a, gate_b = torch.sigmoid(proj).chunk(2, dim=-1)  # (B, H, T, 1) each
        gate = gate_a * (gate_b * lp["gru_const"][None, :, None, None] - 1.0) + 2.0
        scores = scores + gate * pos_bias[None]
    if pad_mask is not None:
        scores = scores + pad_mask[:, None, None, :]
    attn = torch.softmax(scores, dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(b, t, d)
    return _linear(lp["o"], out)


def _ffn(lp: dict, x: torch.Tensor) -> torch.Tensor:
    return _linear(lp["fc2"], _gelu(_linear(lp["fc1"], x)))


def encoder_forward(cfg: SSLConfig, params: dict, x: torch.Tensor,
                    frame_lengths: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Projected features (B, T, D) -> (final, hidden_states (L+1, B, T, D)).

    As HF ``output_hidden_states=True``: entry 0 is the input after the
    positional conv (and the encoder LN in post-LN), entry L the final
    output (after the trailing LN in pre-LN)."""
    b, t, d = x.shape
    pad_mask = None
    if frame_lengths is not None:
        valid = _valid(t, frame_lengths)
        x = x * valid
        pad_mask = torch.where(valid[..., 0], 0.0, torch.finfo(torch.float32).min).to(x.dtype)
    x = x + positional_conv_embedding(cfg, params["pos_conv"], x)
    if not cfg.pre_ln:
        x = _layer_norm(params["encoder_ln"], x, cfg.layer_norm_eps)
    pos_bias = None
    if cfg.rel_pos_bias:
        pos_bias = params["rel_attn_embed"][_buckets_on(cfg, t, x.device)].permute(2, 0, 1)  # (H, T, T)

    hidden = [x]
    h = x
    eps = cfg.layer_norm_eps
    for lp in params["layers"]:
        if cfg.pre_ln:
            h = h + _attention(cfg, lp, _layer_norm(lp["attn_ln"], h, eps), pos_bias, pad_mask)
            h = h + _ffn(lp, _layer_norm(lp["final_ln"], h, eps))
        else:
            h = _layer_norm(lp["attn_ln"], h + _attention(cfg, lp, h, pos_bias, pad_mask), eps)
            h = _layer_norm(lp["final_ln"], h + _ffn(lp, h), eps)
        hidden.append(h)
    if cfg.pre_ln:
        h = _layer_norm(params["encoder_ln"], h, eps)
        hidden[-1] = h
    return h, torch.stack(hidden)


def ssl_forward(cfg: SSLConfig, params: dict, wav: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> dict:
    """Raw waveform (B, S) -> {"x": (B, T, D), "hidden_states": (L+1, B, T, D),
    "frame_lengths": (B,) when ``lengths`` is given}.

    HF ``Wav2Vec2Model / HubertModel / WavLMModel.forward`` with
    ``output_hidden_states=True`` in eval mode; with ``lengths``, valid frames
    equal an exact-length run (see ``conv_feature_extractor``)."""
    feats = conv_feature_extractor(cfg, params, wav, lengths)
    feats = _layer_norm(params["feat_ln"], feats, cfg.layer_norm_eps)
    x = _linear(params["feat_proj"], feats)
    frame_lengths = None if lengths is None else feat_extract_output_length(cfg, lengths)
    final, hidden = encoder_forward(cfg, params, x, frame_lengths)
    out = {"x": final, "hidden_states": hidden}
    if frame_lengths is not None:
        out["frame_lengths"] = frame_lengths
    return out


# ---------------------------------------------------------------------------
# Random init and tree helpers
# ---------------------------------------------------------------------------


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a dict / list tree (None stays None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def tree_leaves(tree, prefix: str = ""):
    """[(path, tensor)] in key order; None leaves are left out."""
    if isinstance(tree, dict):
        return [kv for k in tree for kv in tree_leaves(tree[k], f"{prefix}.{k}" if prefix else k)]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in tree_leaves(v, f"{prefix}.{i}")]
    return [] if tree is None else [(prefix, tree)]


def count_params(tree) -> int:
    return sum(t.numel() for _, t in tree_leaves(tree))


def init_ssl_params(cfg: SSLConfig, generator: torch.Generator) -> dict:
    """Random tree (the JAX ``init_ssl_params``'s scales), drawn from ``generator``."""

    def normal(shape, scale):
        return torch.randn(shape, generator=generator) * scale

    def dense(cin, cout, scale=None):
        return {"w": normal((cout, cin), 1.0 / np.sqrt(cin) if scale is None else scale), "b": torch.zeros(cout)}

    def ln(c):
        return {"scale": torch.ones(c), "bias": torch.zeros(c)}

    conv_layers, cin = [], 1
    for i, (cout, k) in enumerate(zip(cfg.conv_dims, cfg.conv_kernels)):
        layer = {"w": normal((cout, cin, k), 0.5 / np.sqrt(k * cin))}
        if cfg.conv_bias:
            layer["b"] = torch.zeros(cout)
        if (cfg.extract_norm == "group" and i == 0) or cfg.extract_norm == "layer":
            layer["norm_scale"], layer["norm_bias"] = torch.ones(cout), torch.zeros(cout)
        conv_layers.append(layer)
        cin = cout

    d, f = cfg.d_model, cfg.ffn_dim
    hd = d // cfg.num_heads
    layers = []
    for _ in range(cfg.num_layers):
        lp = {"q": dense(d, d), "k": dense(d, d), "v": dense(d, d), "o": dense(d, d), "attn_ln": ln(d),
              "fc1": dense(d, f), "fc2": dense(f, d), "final_ln": ln(d)}
        if cfg.rel_pos_bias:
            lp["gru_w"] = normal((8, hd), 1.0 / np.sqrt(hd))
            lp["gru_b"] = torch.zeros(8)
            lp["gru_const"] = torch.ones(cfg.num_heads)
        layers.append(lp)
    params = {
        "conv_layers": conv_layers,
        "feat_ln": ln(cfg.conv_dims[-1]),
        "feat_proj": dense(cfg.conv_dims[-1], d),
        "pos_conv": {"w": normal((d, d // cfg.conv_pos_groups, cfg.conv_pos_kernel), 0.02), "b": torch.zeros(d)},
        "encoder_ln": ln(d),
        "layers": layers,
    }
    if cfg.rel_pos_bias:
        params["rel_attn_embed"] = normal((cfg.num_buckets, cfg.num_heads), 0.02)
    return params
