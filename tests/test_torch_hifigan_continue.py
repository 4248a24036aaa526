"""The port's HiFi-GAN continuation recipe
(``simwhisper_codec_tpu_torch/experiments/hifigan_continue``) against the
JAX package's (``experiments/hifigan_continue``), on the CPU: the manifests,
the batches, both feature extractors at tiny widths, and the trainer CLI's
``--smoke`` run with its resume.  Tolerances are written at the assertions.
"""

import json
import re
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from experiments.hifigan_continue import data_prepare as jprep
from experiments.hifigan_continue import extract_features as jext
from experiments.hifigan_continue import train as jtrain
from simwhisper_codec_tpu.config import EncoderConfig as JEncoderConfig
from simwhisper_codec_tpu.models import ssl as jssl
from simwhisper_codec_tpu.models import transformer as jt
from simwhisper_codec_tpu_torch.config import EncoderConfig
from simwhisper_codec_tpu_torch.experiments.hifigan_continue import data_prepare as tprep
from simwhisper_codec_tpu_torch.experiments.hifigan_continue import extract_features as text
from simwhisper_codec_tpu_torch.experiments.hifigan_continue import train as ttrain
from simwhisper_codec_tpu_torch.models import ssl as tssl
from simwhisper_codec_tpu_torch.models.transformer import Encoder
from simwhisper_codec_tpu_torch.utils.audio_io import save_audio
from simwhisper_codec_tpu_torch.utils.checkpoint import encoder_state_from_jax, load_training_state, state_digest
from simwhisper_codec_tpu_torch.utils.ssl_checkpoint import ssl_params_from_jax

from torch_port import torch_threads

SR = 16000
ENC_KW = dict(d_model=64, encoder_layers=2, encoder_attention_heads=4, encoder_ffn_dim=128)
# the tiny HuBERT of tests/test_ssl.py (TINY_CFG, post-LN, group norm, no conv bias)
SSL_KW = dict(d_model=64, num_layers=2, num_heads=4, ffn_dim=128, conv_dims=(32, 32, 32), conv_kernels=(10, 3, 2),
              conv_strides=(5, 2, 2), conv_pos_kernel=16, conv_pos_groups=4, pre_ln=False, extract_norm="group",
              conv_bias=False)


def corpus(folder: Path, seconds, seed: int = 0) -> None:
    """WAVs of the given lengths (0 = a silent 1.5 s file) under two subfolders."""
    rng = np.random.default_rng(seed)
    for i, s in enumerate(seconds):
        sub = folder / ("a" if i % 2 else "b")
        sub.mkdir(parents=True, exist_ok=True)
        wav = np.zeros(int(1.5 * SR), np.float32) if s == 0 else (rng.standard_normal(int(s * SR)) * 0.1)
        save_audio(sub / f"utt{i:02d}.wav", wav.astype(np.float32), SR)


def test_prepare_dataset_matches_jax(tmp_path):
    """Same filter (a short and a silent file dropped), split and manifests as the
    JAX package's; a second call is a no-op."""
    corpus(tmp_path / "wavs", [1.2, 0.5, 2.0, 0, 1.1, 3.0, 1.4, 1.7, 2.2, 1.3, 1.05, 2.5, 1.6])
    want = jprep.prepare_dataset(str(tmp_path / "wavs"), str(tmp_path / "jax"))
    got = tprep.prepare_dataset(str(tmp_path / "wavs"), str(tmp_path / "port"))
    manifests = {split: json.loads(Path(got[split]).read_text()) for split in got}
    assert [len(manifests[s]) for s in ("train", "valid", "test")] == [8, 1, 2]
    for split in ("train", "valid", "test"):
        assert manifests[split] == json.loads(Path(want[split]).read_text())
    stamp = Path(got["train"]).stat().st_mtime_ns
    assert tprep.prepare_dataset(str(tmp_path / "wavs"), str(tmp_path / "port")) == got
    assert Path(got["train"]).stat().st_mtime_ns == stamp


def test_make_batches_match_jax(tmp_path):
    """Same seed, same shuffled order, crops and features, batch for batch; the
    incomplete last batch is dropped and an utterance without features skipped."""
    rng = np.random.default_rng(1)
    manifest = {}
    for i, s in enumerate([1.0, 1.3, 0.6, 2.0, 1.1]):
        wav_path = tmp_path / f"u{i}.wav"
        save_audio(wav_path, (rng.standard_normal(int(s * SR)) * 0.1).astype(np.float32), SR)
        if i != 2:
            np.save(tmp_path / f"u{i}.npy", rng.standard_normal((int(s * SR) // 320, 1, 8)).astype(np.float32))
        manifest[f"u{i}"] = {"id": f"u{i}", "wav": str(wav_path), "duration": s}
    want = [{k: np.asarray(v) for k, v in b.items()}
            for b in jtrain.make_batches(manifest, tmp_path, 3, 2560, 320, np.random.default_rng(5), SR)]
    got = list(ttrain.make_batches(manifest, tmp_path, 3, 2560, 320, np.random.default_rng(5), SR))
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert g["features"].shape == (3, 8, 8) and g["audio"].shape == (3, 2560)
        for k in ("features", "audio"):
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("layer_id", [-1, 1])
def test_feature_extractor_matches_jax(layer_id):
    """The Whisper-style extractor (mel, one padded 30 s window, hidden states,
    layer pick) on a tiny encoder within 5e-5 of the JAX extractor."""
    tree = jax.tree.map(np.asarray, jt.init_encoder(jax.random.PRNGKey(3), JEncoderConfig(**ENC_KW)))
    encoder = Encoder(EncoderConfig(**ENC_KW))
    encoder.load_state_dict(encoder_state_from_jax(tree))
    wav = (np.random.default_rng(4).standard_normal(int(1.3 * SR)) * 0.1).astype(np.float32)
    want = jext.FeatureExtractor(JEncoderConfig(**ENC_KW), tree, layer_id).extract(wav)
    got = text.FeatureExtractor(EncoderConfig(**ENC_KW), encoder, layer_id, device="cpu").extract(wav)
    assert got.shape == want.shape == (65, 64)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_hubert_feature_extractor_matches_jax():
    """The HuBERT extractor on the tiny SSL config, both buckets of the
    power-of-two bucketing (1 s and 2 s), within 5e-5 of the JAX extractor."""
    tree = jax.tree.map(np.asarray, jssl.init_ssl_params(jax.random.PRNGKey(5), jssl.SSLConfig(**SSL_KW)))
    want_ext = jext.HubertFeatureExtractor(ssl_cfg=jssl.SSLConfig(**SSL_KW), params=tree, layer_id=1)
    got_ext = text.HubertFeatureExtractor(ssl_cfg=tssl.SSLConfig(**SSL_KW), params=ssl_params_from_jax(tree),
                                          layer_id=1, device="cpu")
    rng = np.random.default_rng(6)
    for n in (12000, 20000):
        wav = (rng.standard_normal(n) * 0.1).astype(np.float32)
        want, got = want_ext.extract(wav), got_ext.extract(wav)
        assert got.shape == want.shape == (tssl.feat_extract_output_length(tssl.SSLConfig(**SSL_KW), n), 64)
        np.testing.assert_allclose(got, want, atol=5e-5)


def test_hubert_extractor_needs_a_local_directory(tmp_path):
    with pytest.raises(RuntimeError, match="not a local model directory"):
        text.HubertFeatureExtractor(model_name=str(tmp_path / "missing"), device="cpu")


def test_trainer_cli_smoke_then_resume():
    """``--smoke --device cpu`` for 2 epochs, then a ``--resume --epochs 3`` run:
    it continues at epoch 3 from epoch 2's checkpoint with that checkpoint's
    state (G, D, both optimizers' moments and learning rates, the step) bit for
    bit, trains one epoch and writes its checkpoint and sample."""
    common = ["--smoke", "--device", "cpu", "--keep_checkpoint_interval", "1"]
    # checkpoints hold the full-width discriminator (~0.85 GB each): a
    # temporary directory, removed at the end, rather than the retained tmp_path
    with tempfile.TemporaryDirectory() as tmp, torch_threads():
        out = Path(tmp)
        ttrain.main(common + ["--output_folder", tmp])
        ckpts = sorted(p.name for p in (out / "checkpoints").glob("*.pt"))
        assert ckpts == ["epoch_0001.pt", "epoch_0002.pt"]
        second = load_training_state(str(out / "checkpoints" / "epoch_0002.pt"))
        assert second["step"] == 4  # four 1 s voices, batch 2: two steps an epoch
        lr = np.float32(np.float32(2e-4) * np.float32(0.9999)) * np.float32(0.9999)  # decayed in f32, as optax's
        for opt in ("g_opt", "d_opt"):
            assert float(second[opt]["param_groups"][0]["lr"]) == float(lr)
        ttrain.main(common + ["--output_folder", tmp, "--resume", "--epochs", "3"])
        log = (out / "train_log.txt").read_text()
        resumed = re.search(r"resumed from epoch_0002\.pt \(next epoch 3, step 4, state digest (\w+)\)", log)
        assert resumed and resumed.group(1) == state_digest(second)
        assert re.search(r"epoch 3: g_loss=[\d.]+ batches=2 ", log)
        third = load_training_state(str(out / "checkpoints" / "epoch_0003.pt"))
        assert third["step"] == 6
        assert not torch.equal(third["generator"]["conv_pre.v"], second["generator"]["conv_pre.v"])
        assert sorted(p.name for p in (out / "samples").iterdir()) == [f"epoch_000{i}.wav" for i in (1, 2, 3)]


def test_entry_points_default_to_cuda(tmp_path):
    """Without a device the extractors and the trainer ask for CUDA and raise
    where there is none; nothing falls back to the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        text.FeatureExtractor(EncoderConfig(**ENC_KW), Encoder(EncoderConfig(**ENC_KW)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        text.HubertFeatureExtractor(allow_random=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--smoke", "--output_folder", str(tmp_path)])
