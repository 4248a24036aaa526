"""Manifests, deterministic distributed sampling and corpus batching.

The port's own copy of ``simwhisper_codec_tpu/utils/data.py`` (numpy only).
Reference ``utils/helpers.py``: JSONL manifest read/filter (:209-265) and
``DistributedWeightedSamplerWrapper`` (:113-207), which draws a
seed-synchronised global weighted sample and shards it by rank
(``indices[rank::num_replicas]``).  Every process draws the same global
sample from ``seed + epoch`` and takes its rank's shard, so the sampler is
resumable and reproducible; corpus evaluation shards files by process and
batches them by length.
"""

from __future__ import annotations

import json
from typing import Iterator, List, Optional, Sequence

import numpy as np


def read_jsonl_manifest(path: str) -> List[dict]:
    """Read a JSONL manifest (one utterance record per line)."""
    records = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def write_jsonl_manifest(path: str, records: Sequence[dict]) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")


def filter_manifest(
    records: Sequence[dict],
    min_duration: Optional[float] = None,
    max_duration: Optional[float] = None,
    duration_key: str = "duration",
) -> List[dict]:
    """Duration-window filter (helpers.py:236-265 semantics)."""
    out = []
    for r in records:
        d = r.get(duration_key)
        if d is None:
            out.append(r)
            continue
        if min_duration is not None and d < min_duration:
            continue
        if max_duration is not None and d > max_duration:
            continue
        out.append(r)
    return out


class DistributedWeightedSampler:
    """Deterministic weighted sampler sharded across processes.

    Every process draws the SAME global multinomial sample (seed + epoch keyed,
    like the reference's seed-synchronized generator, helpers.py:160-198) and
    takes the rank-strided shard ``indices[rank::num_replicas]``.
    """

    def __init__(
        self,
        weights: Sequence[float],
        num_samples: int,
        num_replicas: int,
        rank: int,
        seed: int = 0,
        replacement: bool = True,
    ):
        if rank >= num_replicas:
            raise ValueError(f"rank {rank} >= num_replicas {num_replicas}")
        self.weights = np.asarray(weights, np.float64)
        self.weights = self.weights / self.weights.sum()
        self.num_samples = num_samples
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.replacement = replacement
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + self.epoch)
        indices = rng.choice(
            len(self.weights), size=self.num_samples, replace=self.replacement, p=self.weights
        )
        shard = indices[self.rank :: self.num_replicas]
        return iter(shard.tolist())

    def __len__(self) -> int:
        return (self.num_samples + self.num_replicas - 1 - self.rank) // self.num_replicas


def shard_files_by_process(paths: Sequence[str], process_index: int, process_count: int) -> List[str]:
    """Static rank-strided file sharding for corpus eval (deterministic)."""
    return list(paths)[process_index::process_count]


def length_bucket_batches(
    lengths: Sequence[int], batch_size: int, order: str = "sorted"
) -> List[List[int]]:
    """Group indices into batches of similar length to minimize padding waste.

    The codec pads every batch to 30 s chunks; batching utterances of
    similar length keeps the padded-chunk count (= compute) near its
    minimum.  The reference pads each ad-hoc batch to its max (inference.py).
    """
    idx = np.argsort(np.asarray(lengths)) if order == "sorted" else np.arange(len(lengths))
    return [idx[i : i + batch_size].tolist() for i in range(0, len(idx), batch_size)]
