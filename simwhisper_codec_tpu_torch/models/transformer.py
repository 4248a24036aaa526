"""Whisper-style transformer encoder/decoder.

Counterpart of ``simwhisper_codec_tpu/models/transformer.py`` (reference
``audiocodec/nn/modules.py:85-474``).  Submodules are named after the
reference's state-dict keys (``layers.{i}.self_attn.q_proj``, ...), so a
module's ``state_dict()`` is a reference-layout state dict.  Activations are
channels-last (B, T, D); parameters stay f32 and are cast to the activation
dtype where they are used.

Attention impls: ``dense`` (additive +1.0 / f32-min pair bias, parity
mode's default), ``pflash`` (packed QKV + the ``csrc/pflash.cu`` core) and
``flash`` (per-head q, k, v + the ``csrc/flash.cu`` core, weights normalised
before the value product); on f32 activations (parity mode) the two run the
f32 cores of ``csrc/attn_f32.cu``.  ``packed`` and ``chunked`` are the JAX
package's two XLA impls in plain PyTorch (key-side bias, scores in f32 or,
with ``:bf16``, in bf16); ``parse_attn_impl`` reads the JAX spellings.  FFN
impls: ``dense`` (exact GELU), ``fused`` (``csrc/ln_ffn.cu``) and
``int8-fused`` (``csrc/ln_ffn_int8.cu``; needs
``ops.quant.quantize_stacked_ffn``).

Under tensor parallelism (``parallel/mesh.py::shard_model``) a layer holds
its local heads and its slice of the FFN width and a ``model_group``: its
``out_proj`` and ``fc2`` partial sums are reduced over that group for every
impl.  A layer without a group runs the one-process code.

``Encoder`` also runs the semantic branch (``is_acoustic=False``: exact
GELU after each conv, then the sinusoidal positions) and returns the hidden
states on request; ``GenericTransformer`` is the reference's positional
Transformer encoder (``modules.py:637-734``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from simwhisper_codec_tpu_torch.config import DecoderConfig, EncoderConfig
from simwhisper_codec_tpu_torch.ops.conv import conv1d, conv_transpose1d
from simwhisper_codec_tpu_torch.parallel.mesh import copy_to_model, row_parallel

ATTN_IMPLS = ("dense", "pflash", "flash", "packed", "chunked")
# the spellings the JAX package accepts (codec.py's serving defaults among them)
ATTN_SPELLINGS = ("dense", "flash", "pflash[:<block>]", "packed[:bf16]", "chunked[:<block_q>[:bf16]]")
FFN_IMPLS = ("dense", "fused", "int8-fused")


def parse_attn_impl(spec) -> Tuple[str, dict]:
    """An attention spelling -> (impl, options).  ``pflash:<block>`` runs
    B1 (the block is the JAX kernel's TPU tiling, which B1 does not take);
    ``packed[:bf16]`` and ``chunked[:<block_q>[:bf16]]`` (block_q default
    128) give ``score_dtype`` (f32 unless ``:bf16``) and ``block_q``."""
    parts = spec.split(":") if isinstance(spec, str) else [spec]
    kind, rest = parts[0], parts[1:]
    positive = lambda v: v.isdigit() and int(v) > 0
    ok = {"dense": not rest, "flash": not rest,
          "pflash": len(rest) <= 1 and all(map(positive, rest)),
          "packed": rest in ([], ["bf16"]),
          "chunked": len(rest) <= 2 and all(map(positive, rest[:1])) and rest[1:] in ([], ["bf16"])}.get(kind, False)
    if not ok:
        raise ValueError(f"attn_impl must be one of {ATTN_SPELLINGS}, got {spec!r}")
    opts = {}
    if kind == "packed":
        opts["score_dtype"] = torch.bfloat16 if rest else torch.float32
    elif kind == "chunked":
        opts["block_q"] = int(rest[0]) if rest else 128
        opts["score_dtype"] = torch.bfloat16 if len(rest) > 1 else torch.float32
    return kind, opts


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> torch.Tensor:
    """Sinusoidal positions (reference ``modules.py:52-58``), (length, channels) f32,
    computed in float64 as the JAX package computes them."""
    assert channels % 2 == 0
    log_timescale_increment = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return torch.from_numpy(np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(np.float32))


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing dim with f32 statistics, returned in x.dtype."""
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mean).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * ln.weight.to(torch.float32) + ln.bias.to(torch.float32)).to(x.dtype)


def attention_bias(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B, 1, T, T) f32 bias: +1.0 on valid query/key pairs, f32 min elsewhere."""
    valid = torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]
    pair = valid[:, None, :, None] & valid[:, None, None, :]
    # Python scalars, not tensors made from host values: those are H->D
    # copies, which a CUDA graph capture (utils/aot.py) refuses
    return torch.where(pair, 1.0, torch.finfo(torch.float32).min)


def seq_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) -> (B, T, 1) bool validity mask."""
    return (torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None])[..., None]


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """``nn.Linear`` with its weight and bias cast to x.dtype."""
    bias = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), bias)


class SelfAttention(nn.Module):
    """q/k/v/out projections; k has no bias (Whisper convention).

    ``num_heads`` are the heads this module holds (a model rank's share
    under tensor parallelism) and ``head_dim`` their width, fixed at
    construction: q/k/v project to ``num_heads * head_dim``."""

    def __init__(self, d: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = d // num_heads
        self.model_group = None
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def heads(self, z: torch.Tensor) -> torch.Tensor:
        """(B, T, H hd) -> (B, H, T, hd)."""
        b, t, _ = z.shape
        return z.reshape(b, t, self.num_heads, self.head_dim).transpose(1, 2)

    def merge(self, o: torch.Tensor) -> torch.Tensor:
        """(B, H, T, hd) -> (B, T, H hd)."""
        b, _, t, _ = o.shape
        return o.transpose(1, 2).reshape(b, t, self.num_heads * self.head_dim)

    def project(self, o: torch.Tensor, bias_after: bool = False) -> torch.Tensor:
        """(B, T, H hd) attention output -> out_proj: the whole projection
        (its bias in the product, or with ``bias_after`` added to the
        rounded product, as the kernel wrappers of the JAX package add it),
        or under tensor parallelism this rank's partial reduced over the
        model group, the bias added once (``parallel.mesh.row_parallel``)."""
        if self.model_group is not None:
            return row_parallel(o, self.out_proj, self.model_group)
        if not bias_after:
            return linear(o, self.out_proj)
        b, t, width = o.shape
        return F.linear(o.reshape(b * t, width), self.out_proj.weight.to(o.dtype)).reshape(b, t, -1) \
            + self.out_proj.bias.to(o.dtype)

    def dense(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """Dense attention with the additive pair bias (modules.py:145-187)."""
        q = linear(x, self.q_proj) * self.head_dim ** -0.5
        k = linear(x, self.k_proj)
        v = linear(x, self.v_proj)
        q, k, v = (self.heads(z) for z in (q, k, v))
        scores = (q @ k.transpose(-1, -2)).to(torch.float32) + bias
        weights = torch.softmax(scores, dim=-1).to(x.dtype)
        return self.project(self.merge(weights @ v))


def _key_bias(lengths: torch.Tensor, t: int, dtype) -> torch.Tensor:
    """(B, T) key-side bias in ``dtype``: +1.0 on keys < length, the dtype's minimum elsewhere."""
    valid = torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]
    return torch.where(valid, 1.0, torch.finfo(dtype).min).to(dtype)  # f32 holds the dtype's min exactly


def _scores_softmax(q, k, kbias, score_dtype) -> torch.Tensor:
    """softmax(q k^T + bias) formed in ``score_dtype`` (the products summed in
    f32 and rounded once, as ``preferred_element_type`` gives them), soft-maxed
    op by op in that dtype as ``jax.nn.softmax`` does."""
    scores = (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)).to(score_dtype)
    scores = scores + kbias[:, None, None, :]
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def chunked_attention(attn: SelfAttention, x: torch.Tensor, lengths: torch.Tensor, block_q: int = 128,
                      score_dtype=torch.float32) -> torch.Tensor:
    """The JAX package's ``chunked_attention`` (transformer.py:102-153): q
    padded to a multiple of ``block_q`` and taken a block at a time, each a
    (B, H, block_q, T) score tile; key-side bias; output projection."""
    t = x.shape[1]
    q = (F.linear(x, attn.q_proj.weight.to(x.dtype)) + attn.q_proj.bias.to(x.dtype)) * attn.head_dim ** -0.5
    k = F.linear(x, attn.k_proj.weight.to(x.dtype))
    v = F.linear(x, attn.v_proj.weight.to(x.dtype)) + attn.v_proj.bias.to(x.dtype)
    q, k, v = (attn.heads(z) for z in (q, k, v))
    t_pad = -(-t // block_q) * block_q
    q = F.pad(q, (0, 0, 0, t_pad - t))
    kbias = _key_bias(lengths, t, score_dtype)
    blocks = [_scores_softmax(q[:, :, i:i + block_q], k, kbias, score_dtype).to(v.dtype) @ v
              for i in range(0, t_pad, block_q)]
    return attn.project(attn.merge(torch.cat(blocks, 2)[:, :, :t]))


def packed_attention(attn: SelfAttention, x: torch.Tensor, lengths: torch.Tensor,
                     score_dtype=torch.bfloat16) -> torch.Tensor:
    """The JAX package's ``packed_attention`` (transformer.py:156-199): one
    (D, 3 H hd) product for q, k and v, the whole (B, H, T, T) score tensor,
    key-side bias, output projection."""
    b, t, d = x.shape
    width = attn.num_heads * attn.head_dim
    w = torch.cat([attn.q_proj.weight, attn.k_proj.weight, attn.v_proj.weight], 0).to(x.dtype)
    qkv = (x.reshape(b * t, d) @ w.t()).reshape(b, t, 3 * width)
    q = (qkv[..., :width] + attn.q_proj.bias.to(x.dtype)) * attn.head_dim ** -0.5
    k = qkv[..., width:2 * width]
    v = qkv[..., 2 * width:] + attn.v_proj.bias.to(x.dtype)
    q, k, v = (attn.heads(z) for z in (q, k, v))
    return attn.project(attn.merge(_scores_softmax(q, k, _key_bias(lengths, t, score_dtype), score_dtype)
                                   .to(v.dtype) @ v))


class TransformerLayer(nn.Module):
    """Pre-LN block: LN -> attention -> residual, LN -> FFN -> residual."""

    def __init__(self, d: int, num_heads: int, ffn: int):
        super().__init__()
        self.model_group = None
        self.self_attn_layer_norm = nn.LayerNorm(d)
        self.self_attn = SelfAttention(d, num_heads)
        self.final_layer_norm = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, ffn)
        self.fc2 = nn.Linear(ffn, d)

    def forward(self, x, bias, lengths, attn_impl: str = "dense", ffn_impl: str = "dense"):
        group = self.model_group
        kind, opts = parse_attn_impl(attn_impl)
        h = copy_to_model(layer_norm(x, self.self_attn_layer_norm), group)
        if kind == "pflash":
            from simwhisper_codec_tpu_torch.ops.flash_attention import varlen_attention_pflash

            x = x + varlen_attention_pflash(self.self_attn, h, lengths)
        elif kind == "flash":
            from simwhisper_codec_tpu_torch.ops.flash_attention import varlen_attention_flash

            x = x + varlen_attention_flash(self.self_attn, h, lengths)
        elif kind == "packed":
            x = x + packed_attention(self.self_attn, h, lengths, **opts)
        elif kind == "chunked":
            x = x + chunked_attention(self.self_attn, h, lengths, **opts)
        else:
            x = x + self.self_attn.dense(h, bias)
        b, t, d = x.shape
        xf = x.reshape(b * t, d)
        ln = self.final_layer_norm
        if ffn_impl == "fused":
            from simwhisper_codec_tpu_torch.ops.fused_convnext import fused_ln_ffn

            x = fused_ln_ffn(xf, xf, ln.weight, ln.bias, self.fc1.weight, self.fc1.bias,
                             self.fc2.weight, self.fc2.bias, eps=1e-5, group=group).reshape(b, t, d)
        elif ffn_impl == "int8-fused":
            from simwhisper_codec_tpu_torch.ops.fused_convnext import fused_ln_ffn_int8

            x = fused_ln_ffn_int8(xf, xf, ln.weight, ln.bias, self.fc1_q, self.fc1_s, self.fc1.bias,
                                  self.fc2_q, self.fc2_s, self.fc2.bias, eps=1e-5, group=group).reshape(b, t, d)
        elif ffn_impl == "dense":
            h = copy_to_model(layer_norm(xf, ln), group)
            h = F.gelu(linear(h, self.fc1), approximate="none")
            y = linear(h, self.fc2) if group is None else row_parallel(h, self.fc2, group)
            x = x + y.reshape(b, t, d)
        else:
            raise ValueError(f"ffn_impl must be one of {FFN_IMPLS}, got {ffn_impl!r}")
        if x.dtype == torch.bfloat16:
            # half-precision inf/nan clamp (modules.py:228-231): for bf16,
            # max - 1000 rounds back to max, so it is an unconditional clip
            clamp = torch.finfo(torch.bfloat16).max
            x = torch.clamp(x, -clamp, clamp)
        return x


def run_layers(layers: nn.ModuleList, x, lengths, attn_impl: str, ffn_impl: str, collect: bool = False):
    """The layer stack; with ``collect`` also the list of each layer's input."""
    bias = attention_bias(lengths, x.shape[1]) if parse_attn_impl(attn_impl)[0] == "dense" else None
    inputs = []
    for layer in layers:
        if collect:
            inputs.append(x)
        x = layer(x, bias, lengths, attn_impl, ffn_impl)
    return (x, inputs) if collect else x


def add_positions(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.float32) + positions[: x.shape[1]]).to(x.dtype)


class Encoder(nn.Module):
    """Whisper-style encoder (modules.py:236-376): two convs, then the layer
    stack.  The semantic branch (``is_acoustic=False``) holds its positions
    as a non-persistent buffer, so both branches have the same state-dict
    keys; a reference checkpoint's ``embed_positions.weight`` is not read."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.conv1 = nn.Conv1d(cfg.num_mel_bins, d, cfg.kernel_size, padding=1)
        self.conv2 = nn.Conv1d(d, d, cfg.kernel_size, stride=cfg.stride_size, padding=1)
        self.layers = nn.ModuleList(TransformerLayer(d, cfg.encoder_attention_heads, cfg.encoder_ffn_dim)
                                    for _ in range(cfg.encoder_layers))
        self.layer_norm = nn.LayerNorm(d)
        if not cfg.is_acoustic:
            self.register_buffer("positions", sinusoids(cfg.max_source_positions, d), persistent=False)

    def forward(self, mel, mel_lengths, attn_impl: str = "dense", ffn_impl: str = "dense",
                output_hidden_states: bool = False):
        """mel (B, T_mel, n_mels) -> hidden (B, T_mel // stride, D), lengths (B,),
        and with ``output_hidden_states`` the states (L + 1, B, T, D): the input
        of each layer, then the final LayerNorm's output, each zero past its
        length."""
        semantic = not self.cfg.is_acoustic
        x = conv1d(mel, self.conv1.weight, self.conv1.bias, padding=1)
        if semantic:
            x = F.gelu(x, approximate="none")
        x = conv1d(x, self.conv2.weight, self.conv2.bias, stride=self.cfg.stride_size, padding=1)
        if semantic:
            x = add_positions(F.gelu(x, approximate="none"), self.positions)
        out_lengths = mel_lengths // self.cfg.stride_size
        mask = seq_mask(out_lengths, x.shape[1])
        if not output_hidden_states:
            x = layer_norm(run_layers(self.layers, x, out_lengths, attn_impl, ffn_impl), self.layer_norm)
            return torch.where(mask, x, torch.zeros_like(x)), out_lengths
        if ffn_impl != "dense":
            # the JAX function drops the FFN impl on this path; refuse rather than ignore it
            raise ValueError(f"output_hidden_states runs the dense FFN only, got ffn_impl={ffn_impl!r}")
        x, inputs = run_layers(self.layers, x, out_lengths, attn_impl, "dense", collect=True)
        final = layer_norm(x, self.layer_norm)
        states = torch.stack(inputs + [final])
        return (torch.where(mask, final, torch.zeros_like(final)), out_lengths,
                torch.where(mask[None], states, torch.zeros_like(states)))


class GenericTransformer(nn.Module):
    """The reference's generic Transformer encoder (modules.py:637-734): the
    sinusoidal positions always added, dense attention, sequence length kept.
    Unlike ``Encoder``'s, its hidden states are not masked."""

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, num_layers: int, max_source_positions: int):
        super().__init__()
        self.layers = nn.ModuleList(TransformerLayer(d_model, num_heads, ffn_dim) for _ in range(num_layers))
        self.layer_norm = nn.LayerNorm(d_model)
        self.register_buffer("positions", sinusoids(max_source_positions, d_model), persistent=False)

    def forward(self, x, lengths, output_hidden_states: bool = False):
        """x (B, T, D) -> (B, T, D) masked, lengths, and with
        ``output_hidden_states`` the unmasked states (L + 1, B, T, D)."""
        x = add_positions(x, self.positions)
        mask = seq_mask(lengths, x.shape[1])
        if not output_hidden_states:
            final = layer_norm(run_layers(self.layers, x, lengths, "dense", "dense"), self.layer_norm)
            return torch.where(mask, final, torch.zeros_like(final)), lengths
        x, inputs = run_layers(self.layers, x, lengths, "dense", "dense", collect=True)
        final = layer_norm(x, self.layer_norm)
        return torch.where(mask, final, torch.zeros_like(final)), lengths, torch.stack(inputs + [final])


class Decoder(nn.Module):
    """Transformer mel decoder (modules.py:380-474): layer stack, then two deconvs."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.layers = nn.ModuleList(TransformerLayer(d, cfg.decoder_attention_heads, cfg.decoder_ffn_dim)
                                    for _ in range(cfg.decoder_layers))
        self.layer_norm = nn.LayerNorm(d)
        self.deconv1 = nn.ConvTranspose1d(d, d, cfg.kernel_size, stride=cfg.stride_size)
        self.deconv2 = nn.ConvTranspose1d(d, cfg.num_mel_bins, cfg.kernel_size, stride=1)

    def forward(self, h, lengths, attn_impl: str = "dense", ffn_impl: str = "dense"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """h (B, T, D) -> mel (B, 2T, n_mels), lengths * stride."""
        t = h.shape[1]
        x = run_layers(self.layers, h, lengths, attn_impl, ffn_impl)
        x = layer_norm(x, self.layer_norm)
        x = torch.where(seq_mask(lengths, t), x, torch.zeros_like(x))
        # deconv1: k3 s2 -> 2T+1; deconv2: k3 s1 -> 2T+3; trim to exactly 2T
        x = conv_transpose1d(x, self.deconv1.weight, self.deconv1.bias, stride=self.cfg.stride_size)
        x = conv_transpose1d(x, self.deconv2.weight, self.deconv2.bias, stride=1)
        return x[:, : t * self.cfg.stride_size], lengths * self.cfg.stride_size


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


def init_transformer(module: nn.Module, gen: torch.Generator) -> None:
    """Random init of an Encoder/Decoder (JAX package ``transformer.py:472-531``):
    U(+-1/sqrt(fan_in)) for linears and convs (fan_in = out_channels * k for
    the deconvs, as torch's ConvTranspose1d), LayerNorms at 1 / 0."""
    for sub in module.modules():
        if isinstance(sub, nn.Linear):
            bound = 1.0 / math.sqrt(sub.in_features)
        elif isinstance(sub, nn.ConvTranspose1d):
            bound = 1.0 / math.sqrt(sub.out_channels * sub.kernel_size[0])
        elif isinstance(sub, nn.Conv1d):
            bound = 1.0 / math.sqrt(sub.in_channels // sub.groups * sub.kernel_size[0])
        elif isinstance(sub, nn.LayerNorm):
            nn.init.ones_(sub.weight)
            nn.init.zeros_(sub.bias)
            continue
        else:
            continue
        _uniform_(sub.weight, bound, gen)
        if sub.bias is not None:
            _uniform_(sub.bias, bound, gen)
