"""Offline continuous-feature extraction: audio -> encoder hidden states -> .npy.

Counterpart of ``experiments/hifigan_continue/extract_features.py``
(reference ``extract_code.py:87-219`` + ``local_whisper_ssl.py:22-257``):
run a frozen encoder over each utterance, pick a layer (``layer_id`` -1 =
the last hidden state), save one ``.npy`` of shape [T, 1, D] an utterance.
``FeatureExtractor`` runs the Whisper-style acoustic encoder over one padded
30 s window (E1); ``HubertFeatureExtractor`` runs HuBERT-base on a
power-of-two-second bucket (E2).  Both run in f32 with TF32 off and dense
attention, as the JAX extractors run at ``HIGHEST``; each runs its forward
as a ``utils/aot.py`` program (``program``: a CUDA graph per input shape on
the card: the one 30 s window, or each bucket), the twin of the JAX
extractors' ``jax.jit``.  A fingerprint file of
the manifest, the layer and the extractor's class makes a second call a
no-op; a file that fails is reported and skipped.

Encoder weights, in priority order: a reference codec checkpoint, a local
Hugging Face Whisper directory (``--whisper_model``), or random weights
(``--allow_random``, for pipeline runs).  HuBERT weights: a local HF
directory (``--hubert_model``) or random.  Nothing is downloaded.

Runs on ``cuda`` unless ``--device cpu``.
Run:  python -m simwhisper_codec_tpu_torch.experiments.hifigan_continue.extract_features \\
          --manifest save/train.json --out_dir save/custom_features --allow_random
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from simwhisper_codec_tpu_torch.config import EncoderConfig, FeatureExtractorConfig
from simwhisper_codec_tpu_torch.models.codec import f32_precision, resolve_device
from simwhisper_codec_tpu_torch.models.ssl import (
    hubert_base_config,
    init_ssl_params,
    power_of_two_bucket,
    ssl_forward,
    tree_map,
)
from simwhisper_codec_tpu_torch.models.transformer import Encoder, init_transformer
from simwhisper_codec_tpu_torch.ops.mel import MelConstants, log_mel, mel_lengths
from simwhisper_codec_tpu_torch.utils import aot
from simwhisper_codec_tpu_torch.utils.audio_io import load_audio
from simwhisper_codec_tpu_torch.utils.hf_dir import SAFETENSORS, TORCH_BIN, read_state_dict
from simwhisper_codec_tpu_torch.utils.ssl_checkpoint import convert_hf_ssl


class FeatureExtractor:
    """Mel + encoder with its hidden states over one 30 s window, then the layer pick."""

    def __init__(self, enc_cfg: EncoderConfig, encoder: Encoder, layer_id: int = -1, device=None):
        self.device = resolve_device(device)
        self.enc_cfg = enc_cfg
        self.fe_cfg = FeatureExtractorConfig(feature_size=enc_cfg.num_mel_bins, sampling_rate=enc_cfg.sampling_rate,
                                             hop_length=enc_cfg.hop_length)
        self.mel_consts = MelConstants(self.fe_cfg).to(self.device)
        self.encoder = encoder.to(self.device).eval()
        self.layer_id = layer_id
        self.program = aot.CapturedProgram(self._forward, "hidden_states")

    def _forward(self, wav: torch.Tensor, lengths: torch.Tensor) -> dict:
        feats = log_mel(self.mel_consts, wav)
        lens = mel_lengths(lengths, self.fe_cfg.hop_length, self.mel_consts.n_frames)
        _, out_len, states = self.encoder(feats, lens, output_hidden_states=True)
        return {"features": states[self.layer_id][0], "length": out_len[0]}

    def extract(self, wav: np.ndarray) -> np.ndarray:
        """wav (S,) -> features (T, d_model) of the configured layer."""
        n = self.fe_cfg.n_samples
        length = min(len(wav), n)
        padded = np.zeros((1, n), np.float32)
        padded[0, :length] = wav[:length]
        with torch.no_grad(), f32_precision("highest"):
            out = self.program(torch.from_numpy(padded).to(self.device), torch.tensor([length], device=self.device))
        return out["features"][: int(out["length"])].cpu().numpy()


def hubert_params_from_dir(path, cfg) -> dict:
    """HF ``HubertModel`` (or ``HubertForCTC``: keys under ``hubert.``) directory -> the SSL tree."""
    p = Path(path)
    if not (p / SAFETENSORS).is_file() and not (p / TORCH_BIN).is_file():
        raise RuntimeError(f"Failed to load HuBERT model from {path}: not a local model directory with "
                           f"{SAFETENSORS} or {TORCH_BIN} (--allow_random runs random weights)")
    sd = read_state_dict(p)
    prefix = "hubert." if any(k.startswith("hubert.") for k in sd) else ""
    return convert_hf_ssl(sd, cfg, prefix=prefix)


class HubertFeatureExtractor:
    """HuBERT continuous features (the reference's E2,
    ``hifigan_continue_hubert/continuous_hubert_ssl.py:19-132``): the hidden
    state of a chosen layer, 50 Hz, on ``models/ssl.py`` at
    ``hubert_base_config()``; one utterance a call, zero-padded to its
    power-of-two-second bucket and masked."""

    def __init__(self, ssl_cfg=None, params: dict = None, layer_id: int = -1,
                 model_name: str = "facebook/hubert-base-ls960", allow_random: bool = False, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = ssl_cfg or hubert_base_config()
        if params is None:
            params = (init_ssl_params(self.cfg, torch.Generator().manual_seed(seed)) if allow_random
                      else hubert_params_from_dir(model_name, self.cfg))
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.layer_id = layer_id
        self.program = aot.CapturedProgram(self._forward, "hubert_features")

    def _forward(self, wav: torch.Tensor, lengths: torch.Tensor) -> dict:
        out = ssl_forward(self.cfg, self.params, wav, lengths)
        return {"features": out["hidden_states"][self.layer_id][0], "length": out["frame_lengths"][0]}

    def extract(self, wav: np.ndarray) -> np.ndarray:
        """wav (S,) -> features (T, d) of the configured layer (50 Hz)."""
        n = len(wav)
        padded = np.zeros((1, power_of_two_bucket(n)), np.float32)
        padded[0, :n] = wav
        with torch.no_grad(), f32_precision("highest"):
            out = self.program(torch.from_numpy(padded).to(self.device), torch.tensor([n], device=self.device))
        return out["features"][: int(out["length"])].cpu().numpy()


def extract_manifest(manifest_path: str, out_dir: str, extractor, sample_rate: int = 16000) -> None:
    """Write ``<out_dir>/<utt_id>.npy`` ([T, 1, D] f32) for every manifest entry."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    fingerprint = hashlib.sha256(
        json.dumps([manifest_path, extractor.layer_id, type(extractor).__name__]).encode()
    ).hexdigest()[:16]
    guard = out / f".extract_{fingerprint}"
    if guard.exists():
        return
    manifest = json.loads(Path(manifest_path).read_text())
    for utt_id, rec in manifest.items():
        target = out / f"{utt_id}.npy"
        if target.exists():
            continue
        try:
            feats = extractor.extract(load_audio(rec["wav"], target_sample_rate=sample_rate))
            np.save(target, feats[:, None, :].astype(np.float32))  # reference layout [T, 1, D]
        except Exception as e:  # per-file resilience, as extract_code.py:186-215
            print(f"skipping {utt_id}: {e!r}")
    guard.touch()


def build_encoder_params(enc_cfg: EncoderConfig, codec_checkpoint: str = None, whisper_model: str = None,
                         allow_random: bool = False, seed: int = 0) -> Encoder:
    """The encoder, from a reference codec checkpoint (its ``acoustic_encoder.``
    weights), a local Whisper directory, or random weights from ``seed``."""
    if codec_checkpoint:
        from simwhisper_codec_tpu_torch.utils.checkpoint import load_reference_checkpoint

        return load_reference_checkpoint(Encoder(enc_cfg), codec_checkpoint, prefix="acoustic_encoder.")
    if whisper_model:
        from simwhisper_codec_tpu_torch.utils.whisper_init import load_whisper_encoder_state

        return load_whisper_encoder_state(enc_cfg, whisper_model)
    if allow_random:
        encoder = Encoder(enc_cfg)
        init_transformer(encoder, torch.Generator().manual_seed(seed))
        return encoder
    raise RuntimeError("need --codec_checkpoint, --whisper_model, or --allow_random")


def make_extractor(feature_type: str, layer_id: int = -1, codec_checkpoint: str = None, whisper_model: str = None,
                   hubert_model: str = "facebook/hubert-base-ls960", allow_random: bool = False, device=None):
    """The extractor of ``feature_type`` ("whisper": the encoder at ``EncoderConfig()``;
    "hubert": HuBERT-base), as the CLIs build it."""
    if feature_type == "hubert":
        return HubertFeatureExtractor(layer_id=layer_id, model_name=hubert_model, allow_random=allow_random,
                                      device=device)
    enc_cfg = EncoderConfig()
    encoder = build_encoder_params(enc_cfg, codec_checkpoint, whisper_model, allow_random)
    return FeatureExtractor(enc_cfg, encoder, layer_id, device=device)


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--manifest", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--feature_type", choices=["whisper", "hubert"], default="whisper",
                   help="whisper: codec/Whisper encoder features (E1); hubert: HuBERT-base SSL features (E2)")
    p.add_argument("--layer_id", type=int, default=-1)
    p.add_argument("--codec_checkpoint", default=None)
    p.add_argument("--whisper_model", default=None, help="local Hugging Face Whisper directory")
    p.add_argument("--hubert_model", default="facebook/hubert-base-ls960", help="local Hugging Face HuBERT directory")
    p.add_argument("--allow_random", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = p.parse_args()
    extractor = make_extractor(args.feature_type, args.layer_id, args.codec_checkpoint, args.whisper_model,
                               args.hubert_model, args.allow_random, args.device)
    extract_manifest(args.manifest, args.out_dir, extractor)
    print("done")
