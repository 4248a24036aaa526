"""The SimWhisper-Codec generator's size, read from a configuration's ``generator_params``."""

from __future__ import annotations

from typing import Dict

from benchmark import weights

# the towers' depths; the generator fits one chip whole, so its configurations cut nothing
CUTTABLE = frozenset({"encoder_layers", "decoder_layers", "vocos_layers"})


def parameter_count(cfg: dict) -> int:
    return weights.parameter_count(cfg["generator_params"])


def widths(cfg: dict) -> Dict[str, int]:
    gp = cfg["generator_params"]
    enc, dec, v = gp["acoustic_encoder"], gp["acoustic_decoder"], gp["vocos"]
    return {
        "encoder_layers": enc["encoder_layers"], "encoder_d_model": enc["d_model"],
        "encoder_attention_heads": enc["encoder_attention_heads"], "encoder_ffn_dim": enc["encoder_ffn_dim"],
        "downsample_hidden_dim": gp["downsample"]["hidden_dim"], "latent_dim": gp["downsample"]["latent_dim"],
        "quantizer_groups": gp["quantizer"]["num_groups"], "upsample_hidden_dim": gp["upsample"]["hidden_dim"],
        "decoder_layers": dec["decoder_layers"], "decoder_d_model": dec["d_model"],
        "decoder_attention_heads": dec["decoder_attention_heads"], "decoder_ffn_dim": dec["decoder_ffn_dim"],
        "vocos_layers": v["num_layers"], "vocos_dim": v["dim"], "vocos_intermediate_dim": v["intermediate_dim"],
        "vocos_n_fft": v["n_fft"],
    }
