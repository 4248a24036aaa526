"""Corpus evaluation: a directory of audio -> reconstructions + a throughput report.

Counterpart of ``simwhisper_codec_tpu/eval/corpus.py:33-151``.  Files are
sharded by process (``torch.distributed`` rank and world size when it is
initialised, else one process), except under a data-parallel codec, which
splits every batch over the ranks itself: then each rank takes every file
and rank 0 alone writes.  Files are probed for their lengths, and grouped into
length-bucketed batches; each batch runs the codec's chunked ``encode`` and
``decode``.  The next batch is decoded on the host while the current one
runs (double-buffered loading through the native loader), and the WAV
writes run behind in a bounded queue.  A file that cannot be read is
logged and skipped, as in the reference's eval loops
(``evaluate_model.py:128-141``).
"""

from __future__ import annotations

import json
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from simwhisper_codec_tpu_torch.models.codec import AudioCodec
from simwhisper_codec_tpu_torch.ops.fsq import bits_per_frame
from simwhisper_codec_tpu_torch.utils.audio_io import find_audio_files, probe_audio_length, save_audio
from simwhisper_codec_tpu_torch.utils.data import length_bucket_batches, shard_files_by_process
from simwhisper_codec_tpu_torch.utils.native_loader import load_audio_batch

logger = logging.getLogger(__name__)


def process_index_count() -> Tuple[int, int]:
    """(rank, world size) of ``torch.distributed`` when it is initialised, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def evaluate_corpus(codec: AudioCodec, input_dir: str, output_dir: Optional[str] = None, batch_size: int = 8,
                    overlap_seconds: int = 10, limit: Optional[int] = None) -> dict:
    """Encode + decode every file of this process's shard (of the corpus,
    under a data-parallel codec); returns the throughput stats (and writes
    ``<stem>.wav`` reconstructions, on rank 0 alone under a data-parallel codec).

    ``warmup_seconds`` is the first batch's time (kernel builds, cuDNN
    planning); ``steady_x_realtime`` leaves that batch out of both the audio
    and the clock.  ``bitrate_bps`` is code frames x ``bits_per_frame`` over
    the audio's seconds.
    """
    ctx = codec.dist_context
    # a data-parallel codec runs every batch on all ranks together: no file sharding
    rank, world = (0, 1) if ctx.grouped else process_index_count()
    paths = shard_files_by_process(find_audio_files(input_dir), rank, world)
    if limit:
        paths = paths[:limit]
    if ctx.rank != 0:  # every rank holds the whole batch's output; rank 0 writes it
        output_dir = None
    if output_dir:
        Path(output_dir).mkdir(parents=True, exist_ok=True)

    lengths, good_paths, errors = [], [], []
    for p in paths:
        try:
            lengths.append(probe_audio_length(p, codec.input_sample_rate))
            good_paths.append(p)
        except Exception as e:  # a corrupt header or file: skip it, keep evaluating
            logger.warning("skipping unreadable file %s: %s", p, e)
            errors.append(str(p))
    paths = good_paths
    batches = length_bucket_batches(lengths, batch_size)

    def load(batch_idx):
        return load_audio_batch([paths[i] for i in batch_idx], target_sample_rate=codec.input_sample_rate,
                                on_error="none")

    total_audio_seconds = 0.0
    codes_total = files_done = 0
    warmup_seconds, warmup_audio_seconds = None, 0.0
    pool = ThreadPoolExecutor(max_workers=2)
    write_futures = []
    pending = pool.submit(load, batches[0]) if batches else None
    t0 = time.perf_counter()
    for bnum, batch_idx in enumerate(batches):
        loaded = pending.result()
        pending = pool.submit(load, batches[bnum + 1]) if bnum + 1 < len(batches) else None
        batch_wavs, kept_idx = [], []
        for i, wav in zip(batch_idx, loaded):
            if wav is None:  # a decode failure mid-corpus: skip the file
                logger.warning("skipping undecodable file %s", paths[i])
                errors.append(str(paths[i]))
            else:
                batch_wavs.append(wav)
                kept_idx.append(i)
        if not batch_wavs:
            continue
        enc = codec.encode(batch_wavs, overlap_seconds=overlap_seconds)
        dec = codec.decode(enc["codes_list"], overlap_seconds=overlap_seconds)
        total_audio_seconds += sum(len(w) for w in batch_wavs) / codec.input_sample_rate
        codes_total += sum(c.shape[-1] for c in enc["codes_list"])
        files_done += len(batch_wavs)
        if warmup_seconds is None:
            warmup_seconds = time.perf_counter() - t0
            warmup_audio_seconds = total_audio_seconds
        if output_dir:
            def write(pairs=list(zip(kept_idx, dec["syn_wav_list"]))):
                for i, syn in pairs:
                    save_audio(Path(output_dir) / (Path(paths[i]).stem + ".wav"), np.asarray(syn),
                               codec.output_sample_rate)
            # bounded backlog: at most two batches of decoded audio wait for the disk
            while len(write_futures) > 1:
                write_futures.pop(0).result()
            write_futures.append(pool.submit(write))
    for f in write_futures:
        f.result()  # the writes are part of the pipeline: surface their errors, then stop the clock
    pool.shutdown(wait=True)
    if codec.device.type == "cuda":
        torch.cuda.synchronize(codec.device)
    elapsed = time.perf_counter() - t0

    steady = elapsed - (warmup_seconds or 0.0)
    stats = {
        "files": files_done,
        "skipped": len(errors),
        "audio_seconds": round(total_audio_seconds, 2),
        "wall_seconds": round(elapsed, 2),
        "x_realtime": round(total_audio_seconds / max(elapsed, 1e-9), 2),
        "warmup_seconds": round(warmup_seconds or 0.0, 2),
        "steady_x_realtime": round((total_audio_seconds - warmup_audio_seconds) / steady, 2)
        if steady > 0.5 and total_audio_seconds > warmup_audio_seconds else None,
        "bitrate_bps": round(codes_total * bits_per_frame(codec.cfg.quantizer) / max(total_audio_seconds, 1e-9), 1),
        "num_batches": len(batches),
    }
    if errors:
        stats["skipped_files"] = errors
    logger.info("corpus eval: %s", json.dumps(stats))
    return stats
