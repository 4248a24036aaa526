"""Weights import (the JAX package's trees, the reference ``.pt``) and the
trainer's full-state checkpoints.

The port's modules are named after the reference's state-dict keys, so
``SimWhisperCodec.state_dict()`` is itself a reference-layout state dict:

 - ``params_from_jax`` maps a ``simwhisper_codec_tpu`` parameter tree (numpy
   leaves, layers stacked on a leading axis, convs (W, I, O), linears
   (I, O)) to a state dict in torch layout;
 - ``load_reference_checkpoint`` reads a reference ``SimWhisperCodec.pt``,
   folds weight norm (w = g * v / ||v|| per output channel; old
   ``weight_g``/``weight_v`` or new ``parametrizations`` keys) and loads it
   with ``load_state_dict``.  Reference buffers (filters, windows, FSQ
   levels) are dropped: the port recomputes them;
 - ``generator_state_from_jax`` / ``discriminator_state_from_jax`` map the
   JAX HiFi-GAN trees (weight-normed ``v`` (W, I, O) and ``g``; spectral-
   normed ``w`` with its ``u`` / ``v_vec``) to ``models.hifigan``'s state
   dicts: convs to (O, I, W), transposed convs to (I, O, W), 2-D convs from
   (H, W, I, O) to (O, I, H, W);
 - ``save_training_state`` / ``load_training_state`` are the counterpart of
   ``save_orbax`` / ``load_orbax`` for the trainer's full state.  A save
   writes a temporary file and renames it over the target, so a process
   killed mid-save never leaves a checkpoint that looks complete.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _ln(p) -> dict:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def _linear(p) -> dict:
    out = {"weight": _t(np.asarray(p["w"]).T)}
    if "b" in p:
        out["bias"] = _t(p["b"])
    return out


def _conv(p) -> dict:  # (W, I, O) -> (O, I, W)
    return {"weight": _t(np.transpose(np.asarray(p["w"]), (2, 1, 0))), "bias": _t(p["b"])}


def _deconv(p) -> dict:  # (W, I, O) -> (I, O, W)
    return {"weight": _t(np.transpose(np.asarray(p["w"]), (1, 2, 0))), "bias": _t(p["b"])}


def _index(tree, i):
    if isinstance(tree, Mapping):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _flatten(prefix: str, tree: dict, out: Dict[str, torch.Tensor]) -> None:
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            _flatten(key, v, out)
        else:
            out[key] = v


def _layers(stacked: dict) -> dict:
    n = np.asarray(stacked["fc1"]["w"]).shape[0]
    layers = {}
    for i in range(n):
        p = _index(stacked, i)
        layers[str(i)] = {
            "self_attn_layer_norm": _ln(p["attn_ln"]),
            "self_attn": {"q_proj": _linear(p["q"]), "k_proj": _linear(p["k"]),
                          "v_proj": _linear(p["v"]), "out_proj": _linear(p["o"])},
            "final_layer_norm": _ln(p["final_ln"]),
            "fc1": _linear(p["fc1"]),
            "fc2": _linear(p["fc2"]),
        }
    return layers


def _sampler(p: dict, first: str, last: str) -> dict:
    blocks = {}
    for i, r in enumerate(p["res_blocks"]):
        blocks[str(i)] = {"block": {
            "0": {"act": {"alpha": _t(r["snake1"]["alpha"]), "beta": _t(r["snake1"]["beta"])}},
            "1": _conv(r["conv1"]),
            "2": {"act": {"alpha": _t(r["snake2"]["alpha"]), "beta": _t(r["snake2"]["beta"])}},
            "3": _conv(r["conv2"]),
        }}
    return {first: _conv(p[first]), "res_blocks": blocks, last: _conv(p[last])}


def _vocos(p: dict) -> dict:
    n = np.asarray(p["blocks"]["pw1"]["w"]).shape[0]
    blocks = {}
    for i in range(n):
        b = _index(p["blocks"], i)
        blocks[str(i)] = {
            "dwconv": {"weight": _t(np.transpose(b["dwconv"]["w"], (2, 1, 0))), "bias": _t(b["dwconv"]["b"])},
            "norm": _ln(b["norm"]),
            "pwconv1": _linear(b["pw1"]),
            "pwconv2": _linear(b["pw2"]),
            "gamma": _t(b["gamma"]),
        }
    return {"backbone": {"embed": _conv(p["embed"]), "norm": _ln(p["norm"]), "convnext": blocks,
                         "final_layer_norm": _ln(p["final_ln"])},
            "head": {"out": _linear(p["head"])}}


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX package parameter tree (numpy leaves) -> the port's state dict
    (load it with ``SimWhisperCodec.load_state_dict``)."""
    enc, dec = tree["encoder"], tree["decoder"]
    nested = {
        "acoustic_encoder": {"conv1": _conv(enc["conv1"]), "conv2": _conv(enc["conv2"]),
                             "layers": _layers(enc["layers"]), "layer_norm": _ln(enc["ln"])},
        "downsample": _sampler(tree["downsample"], "in_proj", "to_latent"),
        "upsample": _sampler(tree["upsample"], "from_latent", "to_stacked"),
        "acoustic_decoder": {"layers": _layers(dec["layers"]), "layer_norm": _ln(dec["ln"]),
                             "deconv1": _deconv(dec["deconv1"]), "deconv2": _deconv(dec["deconv2"])},
        "vocos": _vocos(tree["vocos"]),
    }
    out: Dict[str, torch.Tensor] = {}
    _flatten("", nested, out)
    return out


def _hifigan_conv(p: Mapping, perm) -> dict:
    """One HiFi-GAN conv: spectral-normed (``u`` in p) or weight-normed; ``perm``
    maps the JAX layout to torch's."""
    if "u" in p:
        return {"w": _t(np.transpose(np.asarray(p["w"]), perm)), "b": _t(p["b"]), "u": _t(p["u"]),
                "v_vec": _t(p["v_vec"])}
    return {"v": _t(np.transpose(np.asarray(p["v"]), perm)), "g": _t(np.transpose(np.asarray(p["g"]), perm)),
            "b": _t(p["b"])}


_CONV, _DECONV, _CONV2D = (2, 1, 0), (1, 2, 0), (3, 2, 0, 1)


def generator_state_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``init_generator`` tree -> ``models.hifigan.Generator`` state dict."""
    nested = {"conv_pre": _hifigan_conv(tree["conv_pre"], _CONV),
              "ups": {str(i): _hifigan_conv(u, _DECONV) for i, u in enumerate(tree["ups"])},
              "resblocks": {str(i): {str(j): {k: {str(n): _hifigan_conv(c, _CONV) for n, c in enumerate(rb[k])}
                                               for k in ("convs1", "convs2")}
                                     for j, rb in enumerate(stage)}
                            for i, stage in enumerate(tree["resblocks"])},
              "conv_post": _hifigan_conv(tree["conv_post"], _CONV)}
    out: Dict[str, torch.Tensor] = {}
    _flatten("", nested, out)
    return out


def discriminator_state_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``init_discriminator`` tree -> ``models.hifigan.Discriminator`` state dict."""
    def sub(d, perm):
        return {"convs": {str(i): _hifigan_conv(c, perm) for i, c in enumerate(d["convs"])},
                "conv_post": _hifigan_conv(d["conv_post"], perm)}

    nested = {"mpd": {str(i): sub(d, _CONV2D) for i, d in enumerate(tree["mpd"])},
              "msd": {str(i): sub(d, _CONV) for i, d in enumerate(tree["msd"])}}
    out: Dict[str, torch.Tensor] = {}
    _flatten("", nested, out)
    return out


def save_training_state(path: str, state: dict) -> None:
    """``torch.save`` to ``path + ".tmp"``, flushed to disk, then renamed over ``path``."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        torch.save(state, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_training_state(path: str, map_location=None) -> dict:
    """A state written by ``save_training_state``."""
    return torch.load(path, map_location=map_location, weights_only=True)


def _fold_weight_norm(sd: Mapping[str, torch.Tensor], prefix: str):
    for g_key, v_key in ((f"{prefix}.weight_g", f"{prefix}.weight_v"),
                         (f"{prefix}.parametrizations.weight.original0",
                          f"{prefix}.parametrizations.weight.original1")):
        if g_key in sd:
            g, v = sd[g_key].to(torch.float64), sd[v_key].to(torch.float64)
            norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True))
            return (g * v / norm).to(torch.float32)
    return None


def reference_state_dict(sd: Mapping[str, torch.Tensor], model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Reference state dict -> exactly the keys of ``model.state_dict()``."""
    out = {}
    for key in model.state_dict():
        if key in sd:
            out[key] = sd[key].detach().to(torch.float32)
            continue
        folded = _fold_weight_norm(sd, key[: -len(".weight")]) if key.endswith(".weight") else None
        if folded is None:
            raise KeyError(f"missing checkpoint tensor: {key}")
        out[key] = folded
    return out


def load_reference_checkpoint(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Read a reference ``.pt`` (optionally under a ``"model"`` key) into ``model``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    model.load_state_dict(reference_state_dict(ckpt, model), strict=True)
    return model
