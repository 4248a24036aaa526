"""Typed configuration for the PyTorch codec (a copy of the JAX package's ``config.py``).

Parses the reference's published YAML schema verbatim (the nested
``generator_params`` dict whose sub-dicts are module kwargs — reference:
``config/SimWhisperCodec.yaml:1-76``, consumed at ``audiocodec/model.py:16-57``).
Non-constructor keys (``freeze``, ``init_from_whisper``, ``whisper_model_path``)
are accepted and recorded, matching ``model.py:35-39``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import yaml


def _filtered(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclass(frozen=True)
class FeatureExtractorConfig:
    """Whisper-style log-mel frontend (reference feature_extractor.py:19-58)."""

    chunk_length: int = 30
    feature_size: int = 80
    sampling_rate: int = 16000
    hop_length: int = 160
    n_fft: int = 400
    n_samples: int = 480000
    nb_max_frames: int = 3000
    padding_side: str = "right"
    padding_value: float = 0.0
    return_attention_mask: bool = False
    dither: float = 0.0
    max_frequency: Optional[float] = None


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-small-shaped acoustic encoder (reference modules.py:236-285)."""

    num_mel_bins: int = 80
    sampling_rate: int = 16000
    hop_length: int = 160
    stride_size: int = 2
    kernel_size: int = 3
    d_model: int = 768
    scale_embedding: bool = False
    max_audio_seconds: int = 30
    encoder_layers: int = 12
    encoder_attention_heads: int = 12
    encoder_ffn_dim: int = 3072
    activation_function: str = "gelu"
    is_acoustic: bool = True
    freeze: bool = True
    init_from_whisper: bool = False
    whisper_model_path: Optional[str] = None

    @property
    def max_source_positions(self) -> int:
        return (self.max_audio_seconds * self.sampling_rate // self.hop_length) // self.stride_size


@dataclass(frozen=True)
class DecoderConfig:
    """Transformer mel decoder (reference modules.py:380-435)."""

    num_mel_bins: int = 80
    sampling_rate: int = 16000
    hop_length: int = 160
    stride_size: int = 2
    kernel_size: int = 3
    d_model: int = 768
    scale_embedding: bool = False
    max_audio_seconds: int = 30
    decoder_layers: int = 12
    decoder_attention_heads: int = 12
    decoder_ffn_dim: int = 3072
    activation_function: str = "gelu"


@dataclass(frozen=True)
class SampleStackConfig:
    """FrameStackDownConv / FrameStackUpConv (reference modules.py:476-634)."""

    in_dim: int = 768
    out_dim: int = 768
    latent_dim: int = 32
    stack_factor: int = 4
    hidden_dim: int = 512
    dilations: Tuple[int, ...] = (1, 3, 9)


@dataclass(frozen=True)
class QuantizerConfig:
    """GroupFSQ (reference quantizer.py:226-318)."""

    num_groups: int = 8
    num_levels_per_group: Tuple[int, ...] = (8, 7, 6, 6)
    eps: float = 1e-3

    @property
    def codebook_dim(self) -> int:
        return self.num_groups * len(self.num_levels_per_group)

    @property
    def codebook_size_per_group(self) -> int:
        size = 1
        for level in self.num_levels_per_group:
            size *= level
        return size


@dataclass(frozen=True)
class VocosConfig:
    """Vocos vocoder: ConvNeXt backbone + ISTFT head (reference modules.py:1545-1574)."""

    input_channels: int = 80
    dim: int = 512
    intermediate_dim: int = 4096
    num_layers: int = 24
    n_fft: int = 640
    hop_size: int = 160
    padding: str = "same"

    @property
    def layer_scale_init_value(self) -> float:
        return 1.0 / self.num_layers


@dataclass(frozen=True)
class CodecConfig:
    """Full generator configuration (reference model.py:16-57)."""

    input_sample_rate: int = 16000
    output_sample_rate: int = 16000
    mel_hop_length: int = 160
    encoder_downsample_rate: int = 1280
    decoder_upsample_rate: int = 1280
    max_audio_seconds: int = 30

    feature_extractor: FeatureExtractorConfig = field(default_factory=FeatureExtractorConfig)
    acoustic_encoder: EncoderConfig = field(default_factory=EncoderConfig)
    downsample: SampleStackConfig = field(default_factory=SampleStackConfig)
    quantizer: QuantizerConfig = field(default_factory=QuantizerConfig)
    upsample: SampleStackConfig = field(default_factory=SampleStackConfig)
    acoustic_decoder: DecoderConfig = field(default_factory=DecoderConfig)
    vocos: VocosConfig = field(default_factory=VocosConfig)

    # Execution knob (no reference equivalent).
    compute_dtype: str = "float32"  # "float32" for bit parity, "bfloat16" for speed

    @property
    def chunk_samples(self) -> int:
        return self.max_audio_seconds * self.input_sample_rate

    @property
    def mel_frames(self) -> int:
        """Frames per padded 30 s chunk (3000)."""
        return self.chunk_samples // self.mel_hop_length

    @property
    def encoder_frames(self) -> int:
        """Encoder output frames per chunk (1500)."""
        return self.mel_frames // self.acoustic_encoder.stride_size

    @property
    def code_frames(self) -> int:
        """Code frames per chunk (375)."""
        s = self.downsample.stack_factor
        return (self.encoder_frames + s - 1) // s

    @classmethod
    def from_dict(cls, generator_params: dict) -> "CodecConfig":
        gp = dict(generator_params)
        down = dict(gp.get("downsample", {}))
        up = dict(gp.get("upsample", {}))
        quant = dict(gp.get("quantizer", {}))
        if "num_levels_per_group" in quant:
            quant["num_levels_per_group"] = tuple(quant["num_levels_per_group"])
        if "dilations" in down:
            down["dilations"] = tuple(down["dilations"])
        if "dilations" in up:
            up["dilations"] = tuple(up["dilations"])
        return cls(
            input_sample_rate=gp.get("input_sample_rate", 16000),
            output_sample_rate=gp.get("output_sample_rate", 16000),
            mel_hop_length=gp.get("mel_hop_length", 160),
            encoder_downsample_rate=gp.get("encoder_downsample_rate", 1280),
            decoder_upsample_rate=gp.get("decoder_upsample_rate", 1280),
            feature_extractor=FeatureExtractorConfig(
                **_filtered(FeatureExtractorConfig, gp.get("feature_extractor", {}))
            ),
            acoustic_encoder=EncoderConfig(**_filtered(EncoderConfig, gp.get("acoustic_encoder", {}))),
            downsample=SampleStackConfig(**_filtered(SampleStackConfig, down)),
            quantizer=QuantizerConfig(**_filtered(QuantizerConfig, quant)),
            upsample=SampleStackConfig(**_filtered(SampleStackConfig, up)),
            acoustic_decoder=DecoderConfig(**_filtered(DecoderConfig, gp.get("acoustic_decoder", {}))),
            vocos=VocosConfig(**_filtered(VocosConfig, gp.get("vocos", {}))),
            compute_dtype=gp.get("compute_dtype", "float32"),
        )


def load_config(path: str) -> CodecConfig:
    """Load a CodecConfig from a YAML file with the reference schema."""
    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    if "generator_params" in raw:
        raw = raw["generator_params"]
    return CodecConfig.from_dict(raw)
