"""State-dict converters for the SSL towers (HF, fairseq and microsoft layouts).

Counterpart of ``simwhisper_codec_tpu/utils/ssl_checkpoint.py``:
``convert_hf_ssl`` (HF ``Wav2Vec2Model`` / ``HubertModel`` / ``WavLMModel``),
``convert_fairseq_wav2vec2`` (the wav2vec2-small inside the UTMOS lightning
checkpoint, reference ``tools/utmos/utmos.py:102-110``) and
``convert_msft_wavlm`` (the WavLM-large inside ``wavlm_large_finetune.pth``)
give the tree of ``models/ssl.py``: torch-layout weights, one dict a layer.
The weight-normed positional conv is folded in numpy, as the JAX
converter folds it, so both packages load the same bits.

``ssl_params_from_jax`` / ``tower_params_from_jax`` carry a JAX package
tree (numpy leaves) into the port: the ``lax.scan``-stacked layers are
unstacked into a list and every weight is transposed to torch's layout.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from simwhisper_codec_tpu_torch.models.ssl import SSLConfig


def to_tensor(x) -> torch.Tensor:
    """A state-dict value (tensor or array) as an f32 CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _lin(sd, prefix) -> dict:
    return {"w": to_tensor(sd[f"{prefix}.weight"]), "b": to_tensor(sd[f"{prefix}.bias"])}


def _ln(sd, prefix) -> dict:
    return {"scale": to_tensor(sd[f"{prefix}.weight"]), "bias": to_tensor(sd[f"{prefix}.bias"])}


def fold_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Weight norm over dim 2 (one norm a tap over (Cout, Cin/groups)), in f32
    numpy as the JAX converter computes it."""
    g, v = np.asarray(g, np.float32), np.asarray(v, np.float32)
    norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fold_pos_conv(sd, prefix: str) -> dict:
    """The weight-normed positional conv, from either key style."""
    for g_key, v_key in ((f"{prefix}.weight_g", f"{prefix}.weight_v"),
                         (f"{prefix}.parametrizations.weight.original0",
                          f"{prefix}.parametrizations.weight.original1")):
        if g_key in sd:
            return {"w": to_tensor(fold_weight_norm(_np(sd[g_key]), _np(sd[v_key]))),
                    "b": to_tensor(sd[f"{prefix}.bias"])}
    return {"w": to_tensor(sd[f"{prefix}.weight"]), "b": to_tensor(sd[f"{prefix}.bias"])}  # already folded


def _conv_layers(sd, cfg: SSLConfig, key, conv: str, norm_keys) -> list:
    """The feature encoder's convs; ``norm_keys(i)`` lists the candidate norm
    prefixes of layer i."""
    layers = []
    for i in range(len(cfg.conv_dims)):
        layer = {"w": to_tensor(sd[key(f"feature_extractor.conv_layers.{i}.{conv}.weight")])}
        if key(f"feature_extractor.conv_layers.{i}.{conv}.bias") in sd:
            layer["b"] = to_tensor(sd[key(f"feature_extractor.conv_layers.{i}.{conv}.bias")])
        for nk in norm_keys(i):
            if key(f"{nk}.weight") in sd:
                layer["norm_scale"] = to_tensor(sd[key(f"{nk}.weight")])
                layer["norm_bias"] = to_tensor(sd[key(f"{nk}.bias")])
                break
        layers.append(layer)
    return layers


def convert_hf_ssl(sd: Dict, cfg: SSLConfig, prefix: str = "") -> dict:
    """HF Wav2Vec2Model / HubertModel / WavLMModel state dict -> tree."""

    def key(name):
        return f"{prefix}{name}"

    layers = []
    for i in range(cfg.num_layers):
        lp = key(f"encoder.layers.{i}")
        layer = {
            "q": _lin(sd, f"{lp}.attention.q_proj"),
            "k": _lin(sd, f"{lp}.attention.k_proj"),
            "v": _lin(sd, f"{lp}.attention.v_proj"),
            "o": _lin(sd, f"{lp}.attention.out_proj"),
            "attn_ln": _ln(sd, f"{lp}.layer_norm"),
            "fc1": _lin(sd, f"{lp}.feed_forward.intermediate_dense"),
            "fc2": _lin(sd, f"{lp}.feed_forward.output_dense"),
            "final_ln": _ln(sd, f"{lp}.final_layer_norm"),
        }
        if cfg.rel_pos_bias:
            gru = _lin(sd, f"{lp}.attention.gru_rel_pos_linear")
            layer["gru_w"], layer["gru_b"] = gru["w"], gru["b"]
            layer["gru_const"] = to_tensor(sd[f"{lp}.attention.gru_rel_pos_const"]).reshape(-1)
        layers.append(layer)
    params = {
        "conv_layers": _conv_layers(sd, cfg, key, "conv", lambda i: [f"feature_extractor.conv_layers.{i}.layer_norm"]),
        "feat_ln": _ln(sd, key("feature_projection.layer_norm")),
        "feat_proj": _lin(sd, key("feature_projection.projection")),
        "pos_conv": _fold_pos_conv(sd, key("encoder.pos_conv_embed.conv")),
        "encoder_ln": _ln(sd, key("encoder.layer_norm")),
        "layers": layers,
    }
    if cfg.rel_pos_bias:
        params["rel_attn_embed"] = to_tensor(sd[key("encoder.layers.0.attention.rel_attn_embed.weight")])
    return params


def _fairseq_layers(sd, cfg: SSLConfig, key, gate: bool) -> list:
    layers = []
    for i in range(cfg.num_layers):
        lp = key(f"encoder.layers.{i}")
        layer = {
            "q": _lin(sd, f"{lp}.self_attn.q_proj"),
            "k": _lin(sd, f"{lp}.self_attn.k_proj"),
            "v": _lin(sd, f"{lp}.self_attn.v_proj"),
            "o": _lin(sd, f"{lp}.self_attn.out_proj"),
            "attn_ln": _ln(sd, f"{lp}.self_attn_layer_norm"),
            "fc1": _lin(sd, f"{lp}.fc1"),
            "fc2": _lin(sd, f"{lp}.fc2"),
            "final_ln": _ln(sd, f"{lp}.final_layer_norm"),
        }
        if gate:
            gru = _lin(sd, f"{lp}.self_attn.grep_linear")
            layer["gru_w"], layer["gru_b"] = gru["w"], gru["b"]
            layer["gru_const"] = to_tensor(sd[f"{lp}.self_attn.grep_a"]).reshape(-1)
        layers.append(layer)
    return layers


def convert_fairseq_wav2vec2(sd: Dict, cfg: SSLConfig, prefix: str = "") -> dict:
    """fairseq Wav2Vec2Model state dict -> tree.  fairseq layout:

      feature_extractor.conv_layers.{i}.0.weight        conv
      feature_extractor.conv_layers.0.2.{weight,bias}   GroupNorm (layer 0 only)
      layer_norm.{weight,bias}                          feature LN
      post_extract_proj.{weight,bias}
      encoder.pos_conv.0.{weight_g,weight_v,bias}
      encoder.layers.{i}.self_attn.{q,k,v,out}_proj     post-LN transformer
      encoder.layers.{i}.{self_attn_layer_norm,fc1,fc2,final_layer_norm}
      encoder.layer_norm.{weight,bias}
    """

    def key(name):
        return f"{prefix}{name}"

    return {
        "conv_layers": _conv_layers(sd, cfg, key, "0",
                                    lambda i: ["feature_extractor.conv_layers.0.2"] if i == 0 else []),
        "feat_ln": _ln(sd, key("layer_norm")),
        "feat_proj": _lin(sd, key("post_extract_proj")),
        "pos_conv": _fold_pos_conv(sd, key("encoder.pos_conv.0")),
        "encoder_ln": _ln(sd, key("encoder.layer_norm")),
        "layers": _fairseq_layers(sd, cfg, key, gate=False),
    }


def convert_msft_wavlm(sd: Dict, cfg: SSLConfig, prefix: str = "") -> dict:
    """microsoft/UniSpeech WavLM state dict (the tower inside
    ``wavlm_large_finetune.pth``, under ``feature_extract.model.``) -> tree.
    On top of the fairseq layout:

      feature_extractor.conv_layers.{i}.2.1.{weight,bias}   per-layer LN
      encoder.layers.{i}.self_attn.grep_linear.{weight,bias} gate
      encoder.layers.{i}.self_attn.grep_a                   gate const
      encoder.layers.0.self_attn.relative_attention_bias.weight  bucket table
    """

    def key(name):
        return f"{prefix}{name}"

    params = {
        "conv_layers": _conv_layers(sd, cfg, key, "0", lambda i: [f"feature_extractor.conv_layers.{i}.2.1"] + (
            ["feature_extractor.conv_layers.0.2"] if i == 0 else [])),
        "feat_ln": _ln(sd, key("layer_norm")),
        "feat_proj": _lin(sd, key("post_extract_proj")),
        "pos_conv": _fold_pos_conv(sd, key("encoder.pos_conv.0")),
        "encoder_ln": _ln(sd, key("encoder.layer_norm")),
        "layers": _fairseq_layers(sd, cfg, key, gate=cfg.rel_pos_bias),
    }
    if cfg.rel_pos_bias:
        params["rel_attn_embed"] = to_tensor(sd[key("encoder.layers.0.self_attn.relative_attention_bias.weight")])
    return params


# ---------------------------------------------------------------------------
# JAX package trees (numpy leaves) -> the port's trees
# ---------------------------------------------------------------------------

_TRANSPOSED = ("w", "gru_w", "w_ih", "w_hh")  # JAX (in, out) / (K, Cin, Cout) leaves


def _leaf_from_jax(name: str, x):
    if x is None:
        return None
    a = np.asarray(x, np.float32)
    if name in _TRANSPOSED:
        a = a.T if a.ndim == 2 else a.transpose(2, 1, 0)
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def _unstack(tree: dict, i: int) -> dict:
    return {k: _unstack(v, i) if isinstance(v, dict) else np.asarray(v)[i] for k, v in tree.items()}


def tower_params_from_jax(tree, name: str = ""):
    """Any tower tree of the JAX package (SSL, UTMOS, ECAPA, CTC) -> the port's."""
    if isinstance(tree, dict):
        if name == "layers":
            n = len(np.asarray(tree["q"]["w"]))
            return [tower_params_from_jax(_unstack(tree, i)) for i in range(n)]
        return {k: tower_params_from_jax(v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tower_params_from_jax(v, name) for v in tree]
    return _leaf_from_jax(name, tree)


def ssl_params_from_jax(tree: dict) -> dict:
    """A JAX ``models/ssl.py`` tree -> the port's."""
    return tower_params_from_jax(tree)
