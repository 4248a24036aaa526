"""The speaker tower's size (WavLM-Large + ECAPA-TDNN), read from a configuration's ``wavlm_ecapa``."""

from __future__ import annotations

from typing import Dict

from benchmark import speaker_weights

# the transformer's depth; the tower fits one chip whole, so its configurations cut nothing
CUTTABLE = frozenset({"wavlm_layers"})


def parameter_count(cfg: dict) -> int:
    """Every tensor of the published state dict (``speaker_weights.param_specs``)."""
    return speaker_weights.parameter_count(cfg["wavlm_ecapa"])


def widths(cfg: dict) -> Dict[str, int]:
    a = cfg["wavlm_ecapa"]
    conv = set(a["conv_dims"])
    if len(conv) != 1:
        raise ValueError(f"the published conv stack is one width, got {a['conv_dims']}")
    return {
        "wavlm_layers": a["layers"], "d_model": a["d_model"], "heads": a["heads"], "ffn": a["ffn"],
        "conv_dim": conv.pop(), "conv_layers": len(a["conv_dims"]), "pos_conv_kernel": a["pos_conv_kernel"],
        "pos_conv_groups": a["pos_conv_groups"], "rel_pos_buckets": a["rel_pos_buckets"],
        "rel_pos_max_distance": a["rel_pos_max_distance"], "hidden_states": a["layers"] + 1,
        "ecapa_channels": a["ecapa_channels"], "ecapa_scale": a["ecapa_scale"],
        "ecapa_mfa_channels": a["ecapa_mfa_channels"], "embedding_dim": a["embedding_dim"],
    }
