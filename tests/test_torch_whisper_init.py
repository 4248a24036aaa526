"""``utils/whisper_init.py``: the port reads a local Hugging Face Whisper
directory by its files and must load exactly what the JAX package's
``load_whisper_encoder_params`` (through ``transformers``) loads, leaf for
leaf, from a tiny random Whisper saved as safetensors (``WhisperModel``) or
as ``pytorch_model.bin`` (``WhisperForConditionalGeneration``, keys under
``model.encoder.``)."""

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from simwhisper_codec_tpu.config import EncoderConfig as JEncoderConfig
from simwhisper_codec_tpu.utils.whisper_init import load_whisper_encoder_params
from simwhisper_codec_tpu_torch.config import EncoderConfig
from simwhisper_codec_tpu_torch.experiments.hifigan_continue.extract_features import build_encoder_params
from simwhisper_codec_tpu_torch.utils.checkpoint import encoder_state_from_jax
from simwhisper_codec_tpu_torch.utils.whisper_init import load_whisper_encoder_state

ENC_KW = dict(d_model=64, encoder_layers=2, encoder_attention_heads=4, encoder_ffn_dim=128)


def tiny_whisper(cls, path, safe: bool) -> None:
    torch.manual_seed(0)
    cfg = transformers.WhisperConfig(
        vocab_size=64, num_mel_bins=80, d_model=64, encoder_layers=2, encoder_attention_heads=4,
        encoder_ffn_dim=128, decoder_layers=1, decoder_attention_heads=4, decoder_ffn_dim=128,
        max_source_positions=1500, max_target_positions=32, pad_token_id=0, bos_token_id=1, eos_token_id=2,
        decoder_start_token_id=1)
    model = getattr(transformers, cls)(cfg).eval()
    with torch.no_grad():  # no zero biases or identity norms
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    model.save_pretrained(path, safe_serialization=safe)


@pytest.mark.parametrize("cls,safe", [("WhisperModel", True), ("WhisperForConditionalGeneration", False)])
def test_whisper_encoder_matches_jax_loader(tmp_path, cls, safe):
    tiny_whisper(cls, tmp_path, safe)
    want = encoder_state_from_jax(jax.tree.map(
        np.asarray, load_whisper_encoder_params(JEncoderConfig(**ENC_KW), str(tmp_path), local_files_only=True)))
    for encoder in (load_whisper_encoder_state(EncoderConfig(**ENC_KW), tmp_path),
                    build_encoder_params(EncoderConfig(**ENC_KW), whisper_model=str(tmp_path))):
        got = encoder.state_dict()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


def test_missing_whisper_directory_raises(tmp_path):
    with pytest.raises(RuntimeError, match="missing"):
        load_whisper_encoder_state(EncoderConfig(**ENC_KW), tmp_path / "missing")
