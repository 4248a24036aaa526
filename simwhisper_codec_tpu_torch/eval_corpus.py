"""Corpus round trip and quality report: directory -> reconstructions + one JSON report.

Counterpart of ``tools/eval_corpus.py``.  Drives ``eval/corpus.py``
(length-bucketed batches, process-sharded file lists) and, with
``--full-report``, scores the (original, reconstruction) pairs:

  quality   STOI, PESQ-WB/NB (native P.862), SI-SNR, SNR, LSD, MCD
            (``eval/evaluator.py``, numpy on the host)
  towers    WER (HuBERT-large CTC), UTMOS (wav2vec2-base + BiLSTM) and
            speaker similarity (WavLM-large + ECAPA), on the device in f32
            with TF32 off, from the files ``--asr_model``,
            ``--utmos_checkpoint`` and ``--ecapa_checkpoint`` name
            (``python -m simwhisper_codec_tpu_torch.tools.make_synthetic_tower_weights``
            writes synthetic ones)

and reports each part's wall seconds under ``timing``, with each tower's
ms per audio second (warm: after an untimed call of each shape it meets;
the speaker tower's batched calls, ``SpeakerEmbedder.warm``) and peak
device memory.  ``--synthetic N`` first writes
an N-utterance synthetic FLAC corpus.  Runs on ``cuda`` unless
``--device cpu``.

Run:  python -m simwhisper_codec_tpu_torch.eval_corpus --synthetic 8 --allow_random \\
          --output_dir out --full-report --asr_model w/hubert_ctc \\
          --utmos_checkpoint w/utmos22_strong.ckpt --ecapa_checkpoint w/wavlm_large_finetune.pth
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from simwhisper_codec_tpu_torch.config import load_config
from simwhisper_codec_tpu_torch.eval import evaluator
from simwhisper_codec_tpu_torch.eval import metrics as M
from simwhisper_codec_tpu_torch.eval.codebook import corpus_codebook_stats
from simwhisper_codec_tpu_torch.eval.corpus import evaluate_corpus
from simwhisper_codec_tpu_torch.eval.speaker import SpeakerEmbedder, pair_calls
from simwhisper_codec_tpu_torch.eval.utmos import UTMOSScorer
from simwhisper_codec_tpu_torch.eval.wer import Calculator, CTCTranscriber, have_asr
from simwhisper_codec_tpu_torch.models.codec import AudioCodec, init_params, resolve_device
from simwhisper_codec_tpu_torch.models.ssl import power_of_two_bucket
from simwhisper_codec_tpu_torch.parallel import dist
from simwhisper_codec_tpu_torch.utils.audio_io import find_audio_files, load_audio, set_logging
from simwhisper_codec_tpu_torch.utils.flac import write_flac


def make_synthetic_corpus(out_dir: Path, n: int, seed: int = 0, dur_range=(1.0, 4.0)) -> None:
    """N speech-like utterances (varied f0 and envelope) as 16 kHz FLAC."""
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    sr = 16000
    for i in range(n):
        dur = rng.uniform(*dur_range)
        t = np.arange(int(sr * dur)) / sr
        f0 = rng.uniform(90, 240) + 25 * np.sin(2 * np.pi * rng.uniform(1, 4) * t)
        sig = sum(np.sin(2 * np.pi * h * np.cumsum(f0) / sr + rng.uniform(0, 6)) / h for h in range(1, 12))
        env = np.clip(np.sin(2 * np.pi * rng.uniform(1.5, 3.5) * t + rng.uniform(0, 6)), 0, None) ** 2
        wav = sig * env * 0.15 + 0.002 * rng.standard_normal(len(t))
        write_flac(out_dir / f"synt{i:03d}.flac", np.clip(wav * 32768, -32768, 32767).astype(np.int64), sr)


def _pairs(input_dir: str, recon_dir: str, limit=None) -> list:
    recon = {Path(p).stem: p for p in find_audio_files(recon_dir)}
    return [(Path(p).stem, p, recon[Path(p).stem]) for p in find_audio_files(input_dir)[: limit or None]
            if Path(p).stem in recon]


def quality_report(input_dir: str, output_dir: str, limit=None) -> dict:
    """Pair originals and reconstructions by stem and average the objective
    metrics of ``eval/evaluator.py::pair_metrics``."""
    rows = [evaluator.pair_metrics(load_audio(orig, 16000), load_audio(rec, 16000), 16000)
            for _, orig, rec in _pairs(input_dir, output_dir, limit)]
    out = {k: round(v, 4) for k, v in evaluator.average_metrics(rows).items()}
    out["num_pairs"] = len(rows)
    out["pesq_impl"] = "itu-wrapper" if M.have_pesq() else "native-p862"
    if out["pesq_impl"] == "native-p862":
        out["pesq_scale_anchor"] = (
            "anchored via in-repo G.711/G.726 fixtures + published corpus averages "
            "(docs/PESQ_CALIBRATION.json); |delta| <= 0.1 at toll quality, <= 0.35 at low-rate ADPCM")
    return out


def _one_a_bucket(wavs) -> list:
    """A waveform of each power-of-two-second bucket of ``wavs``."""
    return list({power_of_two_bucket(len(w)): w for w in wavs}.values())


class _TowerClock:
    """Wall seconds, audio seconds and peak device memory of one tower,
    started after ``warm()`` ran, untimed, a call of each shape the timed
    part meets."""

    def __init__(self, device: torch.device, warm):
        self.device = device
        self.audio_s = 0.0
        t0 = time.perf_counter()
        warm()  # the first call of a shape pays cuDNN / LSTM planning and the graph capture
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        self.t0 = time.perf_counter()
        self.warmup_s = self.t0 - t0

    def result(self, load_s: float) -> dict:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - self.t0
        out = {"load_s": round(load_s, 3), "warmup_s": round(self.warmup_s, 3), "run_s": round(wall, 3),
               "audio_s": round(self.audio_s, 3),
               "ms_per_audio_s": round(1e3 * wall / max(self.audio_s, 1e-9), 3)}
        if self.device.type == "cuda":
            out["peak_bytes"] = torch.cuda.max_memory_allocated(self.device)
        return out


def tower_metrics(input_dir: str, recon_dir: str, asr_model: str = None, utmos_ckpt: str = None,
                  ecapa_ckpt: str = None, trans_dir: str = None, limit=None, device=None,
                  precision: str = "highest") -> dict:
    """The weight-gated towers over (original, reconstruction) pairs
    (reference ``tools/wer/calculate_wer.py:428-502``, ``calculate_utmos.py``,
    ``spk_sim_cal.py``).  WER: with ``trans_dir`` (LibriSpeech
    ``*.trans.txt``) both directories score against the ground truth;
    without it the reconstructions score against the originals'
    recognitions.  UTMOS scores both directories; speaker similarity is the
    mean pairwise cosine.  ``precision``: ``highest`` (TF32 off, the
    default) or ``default`` (TF32).  ``timing`` holds each tower's clock,
    which starts after untimed calls of each shape it meets: one utterance
    of each bucket, the speaker tower's program signatures (``warmup_s``)."""
    device = resolve_device(device)
    pairs = _pairs(input_dir, recon_dir, limit)
    out = {"num_pairs": len(pairs)}
    timing = {}
    audio = {p: load_audio(p, 16000) for _, orig, rec in pairs for p in (orig, rec)}

    def seconds(*paths):
        return sum(len(audio[p]) for p in paths) / 16000

    if asr_model:
        t0 = time.perf_counter()
        asr = CTCTranscriber(asr_model, device=device, precision=precision)
        load_s = time.perf_counter() - t0
        clock = _TowerClock(device, lambda: [asr.transcribe(w) for w in _one_a_bucket(audio.values())])
        truths = {}
        if trans_dir:
            for tf in Path(trans_dir).rglob("*.trans.txt"):
                for line in tf.read_text().splitlines():
                    if " " in line:
                        utt, text = line.split(" ", 1)
                        truths[utt] = text
        calc_rec, calc_orig = Calculator(), Calculator()
        # one scoring population: with transcripts only the covered stems
        uncovered = 0
        for stem, orig_path, rec_path in pairs:
            truth = truths.get(stem)
            if truths and truth is None:
                uncovered += 1
                continue
            hyp_orig = asr.transcribe(audio[orig_path])
            hyp_rec = asr.transcribe(audio[rec_path])
            clock.audio_s += seconds(orig_path, rec_path)
            if truth is not None:
                calc_rec.calculate(stem, hyp_rec, truth)
                calc_orig.calculate(stem, hyp_orig, truth)
            else:
                calc_rec.calculate(stem, hyp_rec, hyp_orig)
        out["wer_rec"] = round(100 * calc_rec.wer, 3)
        if truths:
            out["wer_orig"] = round(100 * calc_orig.wer, 3)
            out["wer_delta"] = round(out["wer_rec"] - out["wer_orig"], 3)
            if uncovered:
                out["wer_pairs_without_transcript"] = uncovered
        else:
            out["wer_mode"] = "rec-vs-orig-asr (no transcripts)"
        timing["wer"] = clock.result(load_s)
        del asr

    if utmos_ckpt:
        t0 = time.perf_counter()
        scorer = UTMOSScorer(utmos_ckpt, device=device, precision=precision)
        load_s = time.perf_counter() - t0
        clock = _TowerClock(device, lambda: [scorer.score(w) for w in _one_a_bucket(audio.values())])
        rec_scores = [scorer.score(audio[p]) for _, _, p in pairs]
        orig_scores = [scorer.score(audio[p]) for _, p, _ in pairs]
        clock.audio_s += sum(seconds(o, r) for _, o, r in pairs)
        out["utmos_rec"] = round(float(np.mean(rec_scores)), 4)
        out["utmos_orig"] = round(float(np.mean(orig_scores)), 4)
        timing["utmos"] = clock.result(load_s)
        del scorer

    if ecapa_ckpt:
        t0 = time.perf_counter()
        emb = SpeakerEmbedder.from_checkpoint(ecapa_ckpt, device=device, precision=precision)
        load_s = time.perf_counter() - t0
        wav_pairs = [(audio[orig_path], audio[rec_path]) for _, orig_path, rec_path in pairs]
        clock = _TowerClock(device, lambda: emb.warm(pair_calls(wav_pairs)))
        sims = emb.similarities(wav_pairs)
        clock.audio_s += sum(seconds(o, r) for _, o, r in pairs)
        out["speaker_sim"] = round(float(np.mean(sims)), 4)
        timing["speaker_sim"] = clock.result(load_s)
        del emb
    out["timing"] = timing
    return out


def gated_metric_status(asr_model: str = None, utmos_ckpt: str = None, ecapa_ckpt: str = None) -> dict:
    """Which weight-gated metric can run, by the presence of its files."""
    return {
        "wer": f"ran ({asr_model})" if asr_model and have_asr(asr_model)
        else "gated: needs --asr_model, a HubertForCTC directory (hubert-large-ls960-ft layout)",
        "utmos": f"ran ({utmos_ckpt})" if utmos_ckpt and Path(utmos_ckpt).is_file()
        else "gated: needs --utmos_checkpoint, a lightning UTMOS checkpoint",
        "speaker_sim": f"ran ({ecapa_ckpt})" if ecapa_ckpt and Path(ecapa_ckpt).is_file()
        else "gated: needs --ecapa_checkpoint, wavlm_large_finetune.pth",
    }


def full_report(codec, input_dir: str, output_dir: str, batch_size: int = 8, overlap_seconds: int = 10,
                limit: Optional[int] = None, codebook_stats: bool = False, asr_model: str = None,
                utmos_ckpt: str = None, ecapa_ckpt: str = None, trans_dir: str = None) -> Optional[dict]:
    """Round trip into ``<output_dir>/reconstructed``, then the quality report,
    the towers that have weights, and their status; ``timing`` holds the wall
    seconds of each part.  Under a data-parallel codec every rank runs the
    round trip, and rank 0 alone (which wrote the reconstructions before its
    ``evaluate_corpus`` returned) scores them; the other ranks return None."""
    recon_dir = str(Path(output_dir) / "reconstructed")
    t0 = time.perf_counter()
    stats = corpus_stats(codec, input_dir, recon_dir, batch_size, overlap_seconds, limit, codebook_stats)
    timing = {"codec_s": round(time.perf_counter() - t0, 3)}
    if codec.dist_context.rank != 0:
        return None
    t0 = time.perf_counter()
    stats["quality"] = quality_report(input_dir, recon_dir, limit)
    timing["host_metrics_s"] = round(time.perf_counter() - t0, 3)
    if asr_model or utmos_ckpt or ecapa_ckpt:
        stats["towers"] = tower_metrics(input_dir, recon_dir, asr_model=asr_model, utmos_ckpt=utmos_ckpt,
                                        ecapa_ckpt=ecapa_ckpt, trans_dir=trans_dir, limit=limit,
                                        device=codec.device)
        timing["towers"] = stats["towers"].pop("timing")
    stats["gated_metrics"] = gated_metric_status(asr_model, utmos_ckpt, ecapa_ckpt)
    stats["mode"] = codec.mode
    stats["timing"] = timing
    return stats


def corpus_stats(codec, input_dir: str, output_dir: str, batch_size: int = 8, overlap_seconds: int = 10,
                 limit: Optional[int] = None, codebook_stats: bool = False) -> dict:
    """``evaluate_corpus`` and, with ``codebook_stats``, the code statistics."""
    stats = evaluate_corpus(codec, input_dir, output_dir, batch_size=batch_size, overlap_seconds=overlap_seconds,
                            limit=limit)
    if codebook_stats:
        paths = find_audio_files(input_dir)[: limit or None]
        stats["codebook"] = corpus_codebook_stats(codec, paths, overlap_seconds=overlap_seconds,
                                                  batch_size=batch_size)
    return stats


def main(argv=None) -> None:
    set_logging()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config_path", default="config/SimWhisperCodec.yaml")
    p.add_argument("--checkpoint_path", default=None)
    p.add_argument("--allow_random", action="store_true", help="random weights (seed 0) from --config_path")
    p.add_argument("--input_dir", default=None)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--overlap_seconds", type=int, default=10)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--mode", default="fast", choices=["fast", "fast-int8", "fast-int8-full", "parity"])
    p.add_argument("--data_parallel", action="store_true",
                   help="split each batch over the ranks of torchrun's process group (one GPU each); "
                        "rank 0 writes, scores and reports")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    p.add_argument("--codebook_stats", action="store_true", help="also report code usage / entropy")
    p.add_argument("--full-report", dest="full_report", action="store_true",
                   help="append the objective quality metrics, the towers and their status")
    p.add_argument("--asr_model", default=None, help="HubertForCTC directory for the WER tower")
    p.add_argument("--utmos_checkpoint", default=None, help="utmos22_strong lightning .ckpt (or synthetic twin)")
    p.add_argument("--ecapa_checkpoint", default=None, help="wavlm_large_finetune.pth (or synthetic twin)")
    p.add_argument("--trans_dir", default=None, help="directory of LibriSpeech *.trans.txt ground truth for WER")
    p.add_argument("--synthetic", type=int, default=None, metavar="N",
                   help="generate an N-utterance synthetic FLAC corpus as input")
    p.add_argument("--synthetic_dur", default="1,4", metavar="LO,HI",
                   help="synthetic utterance duration range in seconds")
    p.add_argument("--wire", default="float32", choices=["float32", "pcm16"],
                   help="host <-> device waveform format")
    p.add_argument("--report_json", default=None, help="also write the report to this path")
    args = p.parse_args(argv)

    if args.synthetic:
        if not args.output_dir:
            p.error("--synthetic requires --output_dir")
        args.input_dir = str(Path(args.output_dir) / "synthetic_corpus")
    elif not args.input_dir:
        p.error("--input_dir is required (or use --synthetic N)")
    if args.full_report and not args.output_dir:
        p.error("--full-report requires --output_dir")

    device = resolve_device(args.device)
    ctx = dist.init_from_env(device) if args.data_parallel else dist.DistContext()
    if args.synthetic:
        if ctx.rank == 0:
            lo, hi = (float(x) for x in args.synthetic_dur.split(","))
            make_synthetic_corpus(Path(args.input_dir), args.synthetic, dur_range=(lo, hi))
        if ctx.grouped:  # the other ranks read the corpus that rank 0 wrote
            torch.distributed.barrier()
    kw = dict(batch_size=args.batch_size, mode=args.mode, device=dist.local_device(ctx, device), wire=args.wire,
              data_parallel=args.data_parallel)
    if args.allow_random:
        cfg = load_config(args.config_path)
        codec = AudioCodec(cfg, init_params(cfg, torch.Generator().manual_seed(0)), **kw)
    else:
        if not args.checkpoint_path:
            p.error("--checkpoint_path is required (or use --allow_random)")
        codec = AudioCodec.load_from_checkpoint(args.config_path, args.checkpoint_path, **kw)
    if args.full_report:
        stats = full_report(codec, args.input_dir, args.output_dir, args.batch_size, args.overlap_seconds,
                            args.limit, args.codebook_stats, args.asr_model, args.utmos_checkpoint,
                            args.ecapa_checkpoint, args.trans_dir)
    else:
        stats = corpus_stats(codec, args.input_dir, args.output_dir, args.batch_size, args.overlap_seconds,
                             args.limit, args.codebook_stats)
    if ctx.grouped:
        torch.distributed.destroy_process_group()
    if ctx.rank != 0:  # the ranks ran the same batches together: rank 0 reports them
        return
    if args.full_report:
        stats["weights"] = "random" if args.allow_random else args.checkpoint_path
    out = json.dumps(stats, indent=2)
    print(out)
    if args.report_json:
        Path(args.report_json).write_text(out)


if __name__ == "__main__":
    main()
