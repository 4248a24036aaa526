"""Continuous-feature HiFi-GAN training recipe (Whisper-encoder or HuBERT features).

Counterpart of ``experiments/hifigan_continue/train.py`` (reference
``hifigan_experiments/hifigan_continue_whisper/train.py:399-492``): data
prep -> offline feature extraction (train and valid manifests) -> GAN
training of a HiFi-GAN V1 generator on the features (``train/gan.py``: D
step, then G step, two AdamW optimizers, ExponentialLR per epoch) ->
full-state checkpoints and one synthesized sample an epoch.  ``--smoke``
runs the training on four synthetic 1 s voices with random features at a
tiny generator width.

Checkpoints: ``checkpoints/epoch_XXXX.pt`` (both models, both optimizers,
the step; written through a temporary file) when the epoch's mean G loss is
a new best or every ``--keep_checkpoint_interval`` epochs.  ``--resume``
loads the newest one and continues at the next epoch, with the JAX recipe's
semantics: the batch rng restarts from ``--seed`` and the best loss from
infinity, so a resumed run does not repeat a continuous one batch for batch.
The log line "resumed from ..." carries ``utils.checkpoint.state_digest``
of the restored state.  Progress goes to ``train_log.txt``.

Runs on ``cuda`` unless ``--device cpu``, with deterministic kernels
(``experiments/codec/train.py::set_determinism``), f32 with TF32 off.  The
GAN step is one program per batch signature (``train/gan.py``, the twin of
the JAX recipe's ``jax.jit`` of its step): a CUDA graph captured after the
first epoch's first step, which is the warm-up; the last short batch of an
epoch is dropped, so a run has one signature.  Each epoch's decayed rate is
a device tensor the replays read.  The epoch line lists how each step ran
(``programs=captured,replayed,...``).

Run:  python -m simwhisper_codec_tpu_torch.experiments.hifigan_continue.train --data_folder wavs
      python -m simwhisper_codec_tpu_torch.experiments.hifigan_continue.train --smoke --device cpu
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from simwhisper_codec_tpu_torch.experiments.codec.train import log_first_capture, set_determinism
from simwhisper_codec_tpu_torch.experiments.hifigan_continue.data_prepare import prepare_dataset
from simwhisper_codec_tpu_torch.experiments.hifigan_continue.extract_features import extract_manifest, make_extractor
from simwhisper_codec_tpu_torch.models.codec import f32_precision, resolve_device
from simwhisper_codec_tpu_torch.models.hifigan import Discriminator, Generator, HifiGanConfig, init_hifigan
from simwhisper_codec_tpu_torch.train.gan import (
    GanTrainState,
    decay_learning_rate,
    gan_program,
    gan_train_step,
    make_gan_optimizers,
    make_mel_loss_constants,
    sample_segment,
)
from simwhisper_codec_tpu_torch.utils.audio_io import load_audio, save_audio, set_logging
from simwhisper_codec_tpu_torch.utils.checkpoint import load_training_state, save_training_state, state_digest

logger = logging.getLogger(__name__)


def make_batches(manifest, feature_dir, batch_size, segment_size, feature_hop, rng, sample_rate):
    """Yield aligned {"features": (B, T, D), "audio": (B, segment_size)} f32
    numpy batches from the manifest in a shuffled order; an incomplete last
    batch is dropped."""
    items = list(manifest.values())
    rng.shuffle(items)
    feats_batch, audio_batch = [], []
    for rec in items:
        feat_path = Path(feature_dir) / f"{rec['id']}.npy"
        if not feat_path.exists():
            continue
        feats = np.load(feat_path)[:, 0, :]  # [T, D]
        audio = load_audio(rec["wav"], target_sample_rate=sample_rate)
        a, f = sample_segment(rng, audio, feats, segment_size, feature_hop)
        feats_batch.append(f)
        audio_batch.append(a)
        if len(feats_batch) == batch_size:
            yield {"features": np.stack(feats_batch).astype(np.float32),
                   "audio": np.stack(audio_batch).astype(np.float32)}
            feats_batch, audio_batch = [], []


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_folder", default=None)
    p.add_argument("--output_folder", default="./results/continuous_hifigan")
    p.add_argument("--epochs", type=int, default=None, help="training epochs (default 220; 2 under --smoke)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--segment_size", type=int, default=8960)
    p.add_argument("--feature_hop", type=int, default=320)
    p.add_argument("--learning_rate", type=float, default=2e-4)
    p.add_argument("--lr_gamma", type=float, default=0.9999)
    p.add_argument("--layer_id", type=int, default=-1)
    p.add_argument("--feature_type", choices=["whisper", "hubert"], default="whisper",
                   help="whisper: codec/Whisper encoder features (E1, hifigan_continue_whisper); "
                        "hubert: HuBERT-base SSL features (E2, hifigan_continue_hubert)")
    p.add_argument("--codec_checkpoint", default=None)
    p.add_argument("--whisper_model", default=None, help="local Hugging Face Whisper directory")
    p.add_argument("--hubert_model", default="facebook/hubert-base-ls960", help="local Hugging Face HuBERT directory")
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--keep_checkpoint_interval", type=int, default=50)
    p.add_argument("--allow_random", action="store_true", help="random-weight feature extractor (pipeline runs)")
    p.add_argument("--smoke", action="store_true", help="tiny synthetic end-to-end run")
    p.add_argument("--resume", action="store_true", help="continue from the latest checkpoint in --output_folder")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return p, p.parse_args(argv)


def smoke_data(save: Path, rng: np.random.Generator, sample_rate: int, feature_hop: int, enc_dim: int) -> dict:
    """Four 1 s noise voices with random [T, 1, enc_dim] features (the JAX recipe's, draw for draw)."""
    save.mkdir(parents=True, exist_ok=True)
    feature_dir = save / "custom_features"
    feature_dir.mkdir(exist_ok=True)
    manifest = {}
    for i in range(4):
        utt = f"smoke{i}"
        wav = (rng.standard_normal(sample_rate) * 0.05).astype(np.float32)
        wav_path = save / f"{utt}.wav"
        save_audio(wav_path, wav, sample_rate)
        feats = rng.standard_normal((len(wav) // feature_hop, 1, enc_dim)).astype(np.float32)
        np.save(feature_dir / f"{utt}.npy", feats)
        manifest[utt] = {"id": utt, "wav": str(wav_path), "duration": 1.0}
    return manifest


def train(args, parser, out: Path, device: torch.device) -> None:
    rng = np.random.default_rng(args.seed)
    save = out / "save"
    feature_dir = save / "custom_features"
    if args.smoke:
        gcfg = HifiGanConfig(in_channels=16, upsample_initial_channel=32)
        if args.epochs is None:  # keep an explicit --epochs (resume runs)
            args.epochs = 2
        args.batch_size, args.segment_size = 2, 2560
        train_manifest = smoke_data(save, rng, args.sample_rate, args.feature_hop, gcfg.in_channels)
    else:
        if not args.data_folder:
            parser.error("--data_folder is required (or use --smoke)")
        gcfg = HifiGanConfig(in_channels=768, upsample_initial_channel=512)
        manifests = prepare_dataset(args.data_folder, str(save), sample_rate=args.sample_rate)
        t0 = time.perf_counter()
        extractor = make_extractor(args.feature_type, args.layer_id, args.codec_checkpoint, args.whisper_model,
                                   args.hubert_model, args.allow_random, device)
        for split in ("train", "valid"):
            extract_manifest(manifests[split], str(feature_dir), extractor, args.sample_rate)
        del extractor
        logger.info("features (%s) of train and valid ready in %.1f s", args.feature_type, time.perf_counter() - t0)
        train_manifest = json.loads(Path(manifests["train"]).read_text())
    if args.epochs is None:
        args.epochs = 220  # the reference recipe's default (hparams/train.yaml)

    generator = init_hifigan(Generator(gcfg), torch.Generator().manual_seed(args.seed)).to(device)
    disc = init_hifigan(Discriminator(), torch.Generator().manual_seed(args.seed + 1)).to(device)
    state = GanTrainState(generator, disc, *make_gan_optimizers(generator, disc, args.learning_rate))
    mel_consts = make_mel_loss_constants(sample_rate=args.sample_rate).to(device)

    ckpt_dir = out / "checkpoints"
    best_loss = float("inf")
    start_epoch = 1
    saved = sorted(ckpt_dir.glob("epoch_*.pt")) if args.resume else []
    if saved:
        state.load_state_dict(load_training_state(str(saved[-1]), map_location=device))
        start_epoch = int(saved[-1].stem.split("_")[1]) + 1
        logger.info("resumed from %s (next epoch %d, step %d, state digest %s)", saved[-1].name, start_epoch,
                    state.step, state_digest(state.state_dict()))
    program = gan_program(state, mel_consts)
    for epoch in range(start_epoch, args.epochs + 1):
        t0 = time.time()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        g_losses, step_ms, sources = [], [], []
        for batch in make_batches(train_manifest, feature_dir, args.batch_size, args.segment_size,
                                  args.feature_hop, rng, args.sample_rate):
            batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            t_step = time.perf_counter()
            g_losses.append(gan_train_step(state, batch, mel_consts)["g_loss"])  # floats: the step has finished
            step_ms.append((time.perf_counter() - t_step) * 1e3)  # a captured step: warm-up plus capture
            sources.append(program.source)
            if program.source == "captured":
                log_first_capture(program, device)
        decay_learning_rate(state, args.lr_gamma)
        avg = sum(g_losses) / max(len(g_losses), 1)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        logger.info("epoch %d: g_loss=%.4f batches=%d time=%.1fs step_ms=%s max_memory_allocated=%s programs=%s",
                    epoch, avg, len(g_losses), time.time() - t0, ",".join(f"{v:.1f}" for v in step_ms), peak,
                    ",".join(sources))
        if avg < best_loss or epoch % args.keep_checkpoint_interval == 0:
            best_loss = min(best_loss, avg)
            ckpt_dir.mkdir(parents=True, exist_ok=True)
            save_training_state(str(ckpt_dir / f"epoch_{epoch:04d}.pt"), state.state_dict())
            logger.info("saved checkpoint at epoch %d", epoch)

        # one progress sample an epoch (reference train.py:203-266)
        sample_feat = Path(feature_dir) / f"{next(iter(train_manifest.values()))['id']}.npy"
        if sample_feat.exists():
            feats = torch.from_numpy(np.load(sample_feat)[None, :, 0, :]).to(device)
            with torch.no_grad(), f32_precision("highest"):
                wav = state.generator(feats)[0].cpu().numpy()
            (out / "samples").mkdir(exist_ok=True)
            save_audio(out / "samples" / f"epoch_{epoch:04d}.wav", wav, args.sample_rate)
    logger.info("training complete; best g_loss %.4f", best_loss)


def main(argv=None) -> None:
    set_logging()
    parser, args = parse_args(argv)
    set_determinism()
    device = resolve_device(args.device)
    out = Path(args.output_folder)
    out.mkdir(parents=True, exist_ok=True)
    # the train log beside the checkpoints (the reference's FileTrainLogger)
    handler = logging.FileHandler(out / "train_log.txt")
    handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
    logging.getLogger().addHandler(handler)
    try:
        train(args, parser, out, device)
    finally:
        logging.getLogger().removeHandler(handler)
        handler.close()


if __name__ == "__main__":
    main()
