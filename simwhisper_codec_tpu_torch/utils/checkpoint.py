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
 - ``encoder_state_from_jax``, ``generic_transformer_state_from_jax``,
   ``resnet_backbone_state_from_jax`` and ``imdct_head_state_from_jax``
   map the JAX trees of one module each (the encoder of either branch, the
   generic Transformer, the Vocos variants) to that module's state dict;
 - ``generator_state_from_jax`` / ``discriminator_state_from_jax`` map the
   JAX HiFi-GAN trees (weight-normed ``v`` (W, I, O) and ``g``; spectral-
   normed ``w`` with its ``u`` / ``v_vec``) to ``models.hifigan``'s state
   dicts: convs to (O, I, W), transposed convs to (I, O, W), 2-D convs from
   (H, W, I, O) to (O, I, H, W);
 - ``save_training_state`` / ``load_training_state`` are the counterpart of
   ``save_orbax`` / ``load_orbax`` for the trainer's full state.  A save
   writes a temporary file and renames it over the target, so a process
   killed mid-save never leaves a checkpoint that looks complete;
   ``state_digest`` hashes such a state, so a resumed process can show that
   it holds what the file holds;
 - ``param_checksum_report`` is the per-tensor integrity report of the JAX
   package's ``utils/checkpoint.py::param_checksum_report`` (path, shape,
   mean, std and the XOR of the float32 words); ``load_reference_checkpoint``
   logs it at INFO on every load, as the JAX ``load_codec_params`` does.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Dict, Mapping, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)


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


def _encoder(enc: Mapping) -> dict:
    return {"conv1": _conv(enc["conv1"]), "conv2": _conv(enc["conv2"]), "layers": _layers(enc["layers"]),
            "layer_norm": _ln(enc["ln"])}


def _flat(nested: dict) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    _flatten("", nested, out)
    return out


def encoder_state_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX encoder tree ({"conv1", "conv2", "layers", "ln"}; acoustic or
    semantic) -> ``models.transformer.Encoder`` state dict."""
    return _flat(_encoder(tree))


def generic_transformer_state_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX generic Transformer tree ({"layers", "ln"}) -> ``GenericTransformer`` state dict."""
    return _flat({"layers": _layers(tree["layers"]), "layer_norm": _ln(tree["ln"])})


def resnet_backbone_state_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``convert_vocos_resnet_backbone`` tree -> ``VocosResNetBackbone`` state
    dict; a gamma (C,) becomes the reference's (C, 1)."""
    blocks = {}
    for i, block in enumerate(tree["resnet"]):
        blocks[str(i)] = {"convs1": {str(j): _conv(c) for j, c in enumerate(block["convs1"])},
                          "convs2": {str(j): _conv(c) for j, c in enumerate(block["convs2"])}}
        if any(g is not None for g in block["gamma"]):
            blocks[str(i)]["gamma"] = {str(j): _t(np.asarray(g).reshape(-1, 1)) for j, g in enumerate(block["gamma"])}
    return _flat({"embed": _conv(tree["embed"]), "resnet": blocks})


def imdct_head_state_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``convert_imdct_head`` tree -> ``IMDCTSymExpHead`` / ``IMDCTCosHead`` state dict."""
    return _flat({"out": _linear(tree["out"])})


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX package parameter tree (numpy leaves) -> the port's state dict
    (load it with ``SimWhisperCodec.load_state_dict``)."""
    enc, dec = tree["encoder"], tree["decoder"]
    nested = {
        "acoustic_encoder": _encoder(enc),
        "downsample": _sampler(tree["downsample"], "in_proj", "to_latent"),
        "upsample": _sampler(tree["upsample"], "from_latent", "to_stacked"),
        "acoustic_decoder": {"layers": _layers(dec["layers"]), "layer_norm": _ln(dec["ln"]),
                             "deconv1": _deconv(dec["deconv1"]), "deconv2": _deconv(dec["deconv2"])},
        "vocos": _vocos(tree["vocos"]),
    }
    return _flat(nested)


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
    return _flat(nested)


def discriminator_state_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``init_discriminator`` tree -> ``models.hifigan.Discriminator`` state dict."""
    def sub(d, perm):
        return {"convs": {str(i): _hifigan_conv(c, perm) for i, c in enumerate(d["convs"])},
                "conv_post": _hifigan_conv(d["conv_post"], perm)}

    nested = {"mpd": {str(i): sub(d, _CONV2D) for i, d in enumerate(tree["mpd"])},
              "msd": {str(i): sub(d, _CONV) for i, d in enumerate(tree["msd"])}}
    return _flat(nested)


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


def state_digest(state) -> str:
    """SHA-256 of a nested training state (dicts in key order, lists, tensors by
    dtype, shape and bytes, other leaves by ``repr``): equal digests mean
    equal states, bit for bit, whatever device the tensors are on."""
    h = hashlib.sha256()

    def visit(x) -> None:
        if isinstance(x, Mapping):
            for k in sorted(x, key=str):
                h.update(f"<{k!r}>".encode())
                visit(x[k])
        elif isinstance(x, (list, tuple)):
            h.update(f"[{len(x)}]".encode())
            for v in x:
                visit(v)
        elif isinstance(x, torch.Tensor):
            t = x.detach().to("cpu").contiguous()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.numpy().tobytes())
        else:
            h.update(repr(x).encode())

    visit(state)
    return h.hexdigest()


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


def load_reference_checkpoint(model: torch.nn.Module, path: str, prefix: str = "") -> torch.nn.Module:
    """Read a reference ``.pt`` (optionally under a ``"model"`` key) into
    ``model``; with ``prefix`` (e.g. ``"acoustic_encoder."``) only the keys
    under it, the prefix removed."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    if prefix:
        ckpt = {k[len(prefix):]: v for k, v in ckpt.items() if k.startswith(prefix)}
    model.load_state_dict(reference_state_dict(ckpt, model), strict=True)
    if logger.isEnabledFor(logging.INFO):
        logger.info("checkpoint %s tensor report:\n%s", path, param_checksum_report(model))
    return model


def xor32(a: np.ndarray) -> int:
    """XOR of the float32 words of ``a`` (0 when empty)."""
    words = np.frombuffer(np.ascontiguousarray(a, np.float32).tobytes(), np.uint32)
    return int(np.bitwise_xor.reduce(words)) if words.size else 0


def param_checksum_report(model_or_state_dict: Union[torch.nn.Module, Mapping[str, torch.Tensor]]) -> str:
    """Per-tensor integrity report, one line a state-dict entry: key, shape,
    mean and std (in float64) and ``xor32``, in the JAX package's format, so
    the reports of two hosts or of the two packages can be compared.  XOR
    ignores order, so a transposed tensor keeps its ``xor32`` and the XOR of
    per-layer lines equals the JAX package's stacked leaf's."""
    sd = model_or_state_dict.state_dict() if isinstance(model_or_state_dict, torch.nn.Module) \
        else model_or_state_dict
    lines = []
    for key, tensor in sd.items():
        a = tensor.detach().cpu().numpy()
        f64 = a.astype(np.float64)
        lines.append(
            f"{key:64s} {str(list(a.shape)):20s} "
            f"mean={f64.mean() if a.size else 0.0:+.6e} std={f64.std() if a.size else 0.0:.6e} "
            f"xor32={xor32(a):08x}"
        )
    return "\n".join(lines)
