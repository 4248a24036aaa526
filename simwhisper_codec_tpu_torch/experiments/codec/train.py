"""Codec adversarial training recipe (the reference's unreleased trainer).

Counterpart of ``experiments/codec/train.py``: audio files -> random
fixed-length crops -> log-mel on the device -> ``train/codec_gan.py``'s D
step / G step with the frozen encoder, full-state checkpoints with exact
resume, JSONL metric logs.  ``--smoke`` runs the whole pipeline on synthetic
audio at a tiny width; ``--small`` is a production-shaped reduced width.

Runs on ``cuda`` unless ``--device cpu``.  Determinism is set before the
first CUDA call (``CUBLAS_WORKSPACE_CONFIG``, deterministic algorithms,
deterministic cuDNN without autotuning), so a resumed run reproduces a
continuous one bit for bit on the same card.  Crops come from a step-keyed
rng, so a resumed run sees the same batches.  A run from step 0 truncates
``train_log.jsonl``; a resumed run appends to it.

Data parallelism (``--data_parallel`` under ``torchrun``): every rank crops
the same global batch (rounded up to a multiple of the world size) and
trains on its own rows; gradients and metrics are averaged over the ranks;
rank 0 alone writes logs and checkpoints (``ckpt_{step:07d}.pt``).

Compiled programs (``utils/aot.py``), the twins of the JAX trainer's
``warm_jit`` / ``jax.jit``: the GAN step (``train/codec_gan.py``), the
segment log-mel and the probe's forward each run as one CUDA graph per
signature on the card.  Step 1 is the warm-up step plus the capture, and its
log row says so (``"program": "captured"``); the rows after it are replays.
The first capture logs the step's signature count, capture time and peak
memory.  ``--aot_dir`` keeps the kernel libraries for later runs
(``ops._cuda.use_aot_dir``); graphs are captured again in each process.  On
the CPU, and over a gloo group, the programs run eagerly.

Held-out quality probe (``--eval_every N``): a fixed batch (the centre crops
of ``--eval_folder``'s files, else unseen-seed synthetic voices 10000+i)
goes through the training forward under ``no_grad`` every N steps and at
the last step; STOI, SI-SNR and PESQ-WB (native P.862) of each item, averaged,
go into ``quality_log.jsonl`` with a step-0 row for the initial weights.
The log is truncated on a fresh run and appended to on ``--resume``; only
rank 0 evaluates.

Run:  python -m simwhisper_codec_tpu_torch.experiments.codec.train --data_folder wavs
      torchrun --nproc_per_node N -m simwhisper_codec_tpu_torch.experiments.codec.train \\
          --data_folder wavs --data_parallel
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import logging
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from simwhisper_codec_tpu_torch.config import (
    CodecConfig,
    DecoderConfig,
    EncoderConfig,
    SampleStackConfig,
    VocosConfig,
)
from simwhisper_codec_tpu_torch.models.codec import f32_precision, init_params, resolve_device, training_forward
from simwhisper_codec_tpu_torch.models.hifigan import Discriminator, init_hifigan
from simwhisper_codec_tpu_torch.ops import _cuda
from simwhisper_codec_tpu_torch.ops.mel import MelConstants, log_mel
from simwhisper_codec_tpu_torch.parallel import dist
from simwhisper_codec_tpu_torch.train.codec_gan import codec_gan_program, codec_gan_step, init_codec_gan_state
from simwhisper_codec_tpu_torch.train.gan import make_mel_loss_constants
from simwhisper_codec_tpu_torch.utils import aot
from simwhisper_codec_tpu_torch.utils.audio_io import find_audio_files, load_audio, set_logging
from simwhisper_codec_tpu_torch.utils.checkpoint import (
    load_reference_checkpoint,
    load_training_state,
    save_training_state,
)
from simwhisper_codec_tpu_torch.utils.params import format_param_report
from simwhisper_codec_tpu_torch.utils.seeding import seed_everything

logger = logging.getLogger(__name__)


def set_determinism() -> None:
    """Deterministic kernels; call before the first CUDA call (cuBLAS reads its
    workspace setting when it initialises)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def width_config(d: int, layers: int, ffn: int, hidden: int) -> CodecConfig:
    return CodecConfig(
        acoustic_encoder=EncoderConfig(d_model=d, encoder_layers=layers, encoder_attention_heads=4,
                                       encoder_ffn_dim=ffn),
        acoustic_decoder=DecoderConfig(d_model=d, decoder_layers=layers, decoder_attention_heads=4,
                                       decoder_ffn_dim=ffn),
        downsample=SampleStackConfig(in_dim=d, latent_dim=32, stack_factor=4, hidden_dim=hidden),
        upsample=SampleStackConfig(out_dim=d, latent_dim=32, stack_factor=4, hidden_dim=hidden),
        vocos=VocosConfig(input_channels=80, dim=d, intermediate_dim=ffn, num_layers=layers),
    )


SMOKE = width_config(64, 2, 128, 48)     # the JAX trainer's --smoke widths
SMALL = width_config(192, 4, 384, 128)   # its --small: every stage present, ~4M parameters


def crop_batch(rng: np.random.Generator, wavs, batch_size: int, segment_samples: int) -> np.ndarray:
    idx = rng.integers(0, len(wavs), batch_size)
    out = np.zeros((batch_size, segment_samples), np.float32)
    for row, i in enumerate(idx):
        w = wavs[i]
        if len(w) > segment_samples:
            start = int(rng.integers(0, len(w) - segment_samples + 1))
            out[row] = w[start: start + segment_samples]
        else:
            out[row, : len(w)] = w
    return out


def segment_mel(cfg: CodecConfig, segment_samples: int) -> MelConstants:
    """Mel constants sized to the training segment (not the 30 s chunk)."""
    fe = dataclasses.replace(cfg.feature_extractor, n_samples=segment_samples,
                             nb_max_frames=segment_samples // cfg.feature_extractor.hop_length,
                             chunk_length=max(1, segment_samples // cfg.feature_extractor.sampling_rate))
    return MelConstants(fe)


def segment_log_mel(seg_mel: MelConstants, audio: torch.Tensor) -> dict:
    """The segment log-mel program's body: (B, S) crops -> {"mel": (B, T_mel, n_mels)}."""
    with torch.no_grad(), f32_precision("highest"):
        return {"mel": log_mel(seg_mel, audio)}


def probe_forward(model, mel: torch.Tensor, lens: torch.Tensor) -> dict:
    """The probe's program body: the training forward without gradients -> {"y": (B, S)}."""
    with torch.no_grad(), f32_precision("highest"):
        return {"y": training_forward(model, mel, lens)["reconstructed_audio"]}


def log_first_capture(program: aot.CapturedProgram, device: torch.device) -> None:
    """The twin of ``warm_jit``'s source / fingerprint line, once a capture has run."""
    logger.info("%s: %d signature(s); warm-up step %.1f ms, then captured in %.1f ms; peak max_memory_allocated "
                "%d", program.name, program.count, program.warm_ms, program.capture_ms,
                torch.cuda.max_memory_allocated(device))


def synthetic_voice(seed: int, seconds: float, sr: int) -> np.ndarray:
    """Formant-modulated harmonic voice (the held-out probe's carriers)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(90, 220) * (1.0 + 0.06 * np.sin(2 * np.pi * rng.uniform(1.5, 3.0) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(h * phase + rng.uniform(0, 6)) / h ** rng.uniform(0.5, 0.9) for h in range(1, 24))
    x *= 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(2.5, 4.0) * t + rng.uniform(0, 6))
    x *= np.clip(np.sin(2 * np.pi * rng.uniform(1.2, 2.2) * t) * 4.0, 0.0, 1.0)
    x = x + 0.005 * rng.standard_normal(len(t))
    return (0.2 * x / np.max(np.abs(x))).astype(np.float32)


def eval_batch(cfg: CodecConfig, segment_samples: int, eval_folder=None) -> np.ndarray:
    """The probe's fixed batch: centre crops (or zero pads) of the folder's
    files, else eight unseen-seed synthetic voices."""
    sr = cfg.input_sample_rate
    if eval_folder:
        raw = [load_audio(path, sr) for path in find_audio_files(eval_folder)]
    else:
        raw = [synthetic_voice(10_000 + i, segment_samples / sr, sr) for i in range(8)]
    batch = np.zeros((len(raw), segment_samples), np.float32)
    for i, w in enumerate(raw):
        if len(w) >= segment_samples:
            s = (len(w) - segment_samples) // 2
            batch[i] = w[s: s + segment_samples]
        else:
            batch[i, : len(w)] = w
    return batch


def score_batch(ref: np.ndarray, deg: np.ndarray, sr: int) -> dict:
    """Mean STOI, SI-SNR and PESQ-WB of (reference, reconstruction) rows; a
    metric with no finite value is None."""
    from simwhisper_codec_tpu_torch.eval import metrics as M

    rows = [{"stoi": M.stoi(r, d, sr), "si_snr": M.si_snr(r, d),
             "pesq_wb": M.pesq_score(r.astype(np.float64), d.astype(np.float64), sr, "wb")}
            for r, d in zip(ref, deg)]
    rec = {"n_eval": len(rows)}
    for k in ("stoi", "si_snr", "pesq_wb"):
        vals = [r[k] for r in rows if r[k] is not None and np.isfinite(r[k])]
        rec[k] = round(float(np.mean(vals)), 4) if vals else None
    return rec


class QualityProbe:
    """Reconstructs the fixed batch through the current weights and appends
    one row a call to ``quality_log.jsonl``."""

    def __init__(self, cfg: CodecConfig, seg_mel: MelConstants, segment_samples: int, mel_frames: int,
                 eval_folder, log_path: Path, device: torch.device):
        self.sr = cfg.input_sample_rate
        self.segment_samples = segment_samples
        self.batch = eval_batch(cfg, segment_samples, eval_folder)
        with torch.no_grad(), f32_precision("highest"):
            self.mel = log_mel(seg_mel, torch.from_numpy(self.batch).to(device))
        self.lens = torch.full((len(self.batch),), mel_frames, dtype=torch.int64, device=device)
        self.log_path = log_path
        self.forward: Optional[aot.CapturedProgram] = None  # the program of the model last scored

    def __call__(self, model, step: int) -> dict:
        if self.forward is None or self.forward.fn.args[0] is not model:
            self.forward = aot.CapturedProgram(functools.partial(probe_forward, model), "probe_forward")
        y = self.forward(self.mel, self.lens)["y"]
        rec = dict(step=step, **score_batch(self.batch, y[:, : self.segment_samples].cpu().numpy(), self.sr))
        logger.info("quality %s", json.dumps(rec))
        with open(self.log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_folder", default=None)
    p.add_argument("--output_folder", default="./results/codec_train")
    p.add_argument("--steps", type=int, default=100000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--segment_seconds", type=float, default=2.0)
    p.add_argument("--learning_rate", type=float, default=2e-4)
    p.add_argument("--checkpoint_every", type=int, default=2000)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--resume", default=None, help="a ckpt_*.pt written by this trainer")
    p.add_argument("--init_checkpoint", default=None, help="reference-layout codec .pt to start from")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--smoke", action="store_true", help="tiny widths on synthetic audio")
    p.add_argument("--small", action="store_true", help="reduced-width production-shaped config")
    p.add_argument("--eval_every", type=int, default=0,
                   help="score a held-out batch (STOI, SI-SNR, PESQ-WB) every N steps into quality_log.jsonl")
    p.add_argument("--eval_folder", default=None, help="held-out audio for --eval_every (synthetic voices without it)")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    p.add_argument("--data_parallel", action="store_true",
                   help="split each global batch over torchrun's ranks (one GPU each)")
    p.add_argument("--aot_dir", default=None,
                   help="directory of the compiled kernel libraries, reused by later runs (also via "
                        "SIMWHISPER_AOT_DIR); the CUDA graphs of the step are captured anew in each process")
    return p, p.parse_args(argv)


def main(argv=None) -> None:
    set_logging()
    parser, args = parse_args(argv)
    set_determinism()
    device = resolve_device(args.device)
    if args.aot_dir is not None and device.type == "cuda":
        _cuda.use_aot_dir(args.aot_dir)
    owns_group = args.data_parallel and not torch.distributed.is_initialized()
    ctx = dist.init_from_env(device) if args.data_parallel else dist.DistContext()
    device = dist.local_device(ctx, device)
    seed_everything(args.seed)
    out = Path(args.output_folder)
    out.mkdir(parents=True, exist_ok=True)

    if args.smoke:
        cfg = SMOKE
        if args.steps == 100000:  # keep an explicitly requested step count
            args.steps = 3
        if args.batch_size == 16:  # keep an explicitly requested batch size
            args.batch_size = 2
        args.segment_seconds = 0.5
        rng = np.random.default_rng(args.seed)
        wavs = [rng.standard_normal(12000).astype(np.float32) * 0.1 for _ in range(4)]
    else:
        cfg = SMALL if args.small else CodecConfig()
        if not args.data_folder:
            parser.error("--data_folder required (or --smoke)")
        paths = find_audio_files(args.data_folder)
        logger.info("loading %d files", len(paths))
        wavs = [load_audio(path, cfg.input_sample_rate) for path in paths]

    t_init = time.perf_counter()
    model = init_params(cfg, torch.Generator().manual_seed(args.seed))
    if args.init_checkpoint:
        load_reference_checkpoint(model, args.init_checkpoint)
    disc = init_hifigan(Discriminator(), torch.Generator().manual_seed(args.seed + 1))
    if ctx.rank == 0:
        logger.info("codec params:\n%s", format_param_report(model))
    state = init_codec_gan_state(model.to(device), disc.to(device), args.learning_rate)
    if args.resume:
        state.load_state_dict(load_training_state(args.resume, map_location=device))
        logger.info("resumed from %s at step %d", args.resume, state.step)
    logger.info("models ready on %s in %.1f s", device, time.perf_counter() - t_init)

    if args.batch_size % ctx.world_size:
        args.batch_size = -(-args.batch_size // ctx.world_size) * ctx.world_size
        logger.info("batch_size rounded up to %d (a multiple of the world size)", args.batch_size)
    rows = ctx.rows(args.batch_size)
    if ctx.grouped:
        logger.info("data-parallel: rank %d of %d, rows %s", ctx.rank, ctx.world_size, rows)

    segment_samples = int(args.segment_seconds * cfg.input_sample_rate)
    # an even mel frame count, so the encoder's stride 2 divides it
    segment_samples = segment_samples // (cfg.mel_hop_length * 2) * (cfg.mel_hop_length * 2)
    mel_frames = segment_samples // cfg.mel_hop_length
    seg_mel = segment_mel(cfg, segment_samples).to(device)
    seg_log_mel = aot.CapturedProgram(functools.partial(segment_log_mel, seg_mel), "segment_log_mel")
    mel_consts = make_mel_loss_constants(sample_rate=cfg.input_sample_rate).to(device)
    program = codec_gan_program(state, mel_consts, ctx)
    n_local = rows.stop - rows.start
    mel_lens = torch.full((n_local,), mel_frames, dtype=torch.int64, device=device)

    log_path = out / "train_log.jsonl"
    start_step = state.step + 1
    if ctx.rank == 0 and start_step == 1:
        log_path.write_text("")  # a fresh run starts a fresh log
    probe = None
    if args.eval_every and ctx.rank == 0:
        probe = QualityProbe(cfg, seg_mel, segment_samples, mel_frames, args.eval_folder, out / "quality_log.jsonl",
                             device)
        if start_step == 1:
            probe.log_path.write_text("")
            probe(state.model, 0)  # the initial weights' row
    t0 = time.time()
    for step in range(start_step, args.steps + 1):
        # step-keyed rng: a resumed run crops the same batches as a continuous
        # one, and every rank crops the same global batch
        audio = crop_batch(np.random.default_rng((args.seed, step)), wavs, args.batch_size, segment_samples)
        audio_t = torch.from_numpy(audio[rows]).to(device)
        batch = {"mel": seg_log_mel(audio_t)["mel"], "mel_lens": mel_lens, "audio": audio_t}
        t_step = time.perf_counter()
        metrics = codec_gan_step(state, batch, mel_consts, ctx)  # floats: the step has finished
        step_ms = (time.perf_counter() - t_step) * 1e3
        if program.source == "captured" and ctx.rank == 0:
            log_first_capture(program, device)
        if ctx.rank == 0 and (step % args.log_every == 0 or step == args.steps):
            # step_ms of a "captured" row is the warm-up step plus the capture
            rec = dict(metrics, step=step, time=round(time.time() - t0, 1), step_ms=step_ms, program=program.source)
            if device.type == "cuda":
                rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
            logger.info("%s", json.dumps(rec))
            with open(log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if probe is not None and (step % args.eval_every == 0 or step == args.steps):
            probe(state.model, step)
        if ctx.rank == 0 and (step % args.checkpoint_every == 0 or step == args.steps):
            t_save = time.perf_counter()
            save_training_state(str(out / f"ckpt_{step:07d}.pt"), state.state_dict())
            logger.info("checkpoint of step %d saved in %.1f s", step, time.perf_counter() - t_save)
    logger.info("done after %d steps", args.steps)
    if owns_group and ctx.grouped:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
