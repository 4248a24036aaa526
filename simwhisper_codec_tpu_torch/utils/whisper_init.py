"""Whisper encoder weights from a local Hugging Face model directory.

Counterpart of ``simwhisper_codec_tpu/utils/whisper_init.py`` (reference
``utils/weight_init.py:11-77``).  The JAX package asks ``transformers`` for
the model; the port reads the directory's files itself
(``model.safetensors`` or ``pytorch_model.bin``, through
``utils/hf_dir.py``) and downloads nothing.  The reference encoder uses
Whisper's module names, so the ``encoder.`` keys (``model.encoder.`` in a
``WhisperForConditionalGeneration`` directory) load as they are; the learned
``embed_positions.weight`` is dropped, as the reference drops it.
"""

from __future__ import annotations

import logging
from pathlib import Path

from simwhisper_codec_tpu_torch.config import EncoderConfig
from simwhisper_codec_tpu_torch.models.transformer import Encoder
from simwhisper_codec_tpu_torch.utils.hf_dir import SAFETENSORS, TORCH_BIN, read_state_dict

logger = logging.getLogger(__name__)

ENCODER_PREFIXES = ("encoder.", "model.encoder.")


def load_whisper_encoder_state(cfg: EncoderConfig, path) -> Encoder:
    """An ``Encoder(cfg)`` holding the Whisper encoder weights of the local
    directory ``path`` (loaded strictly).  Raises ``RuntimeError`` when
    ``path`` is not a directory or holds no encoder weights."""
    p = Path(path)
    if not (p / SAFETENSORS).is_file() and not (p / TORCH_BIN).is_file():
        raise RuntimeError(f"Failed to load Whisper model from {path}: not a local model directory "
                           f"with {SAFETENSORS} or {TORCH_BIN}")
    sd = read_state_dict(p)
    for prefix in ENCODER_PREFIXES:
        enc = {k[len(prefix):]: v.float() for k, v in sd.items() if k.startswith(prefix)}
        if enc:
            break
    else:
        raise RuntimeError(f"Failed to load Whisper model from {path}: no encoder weights")
    enc.pop("embed_positions.weight", None)
    encoder = Encoder(cfg)
    encoder.load_state_dict(enc, strict=True)
    logger.info("Loaded Whisper encoder weights from %s", path)
    return encoder
