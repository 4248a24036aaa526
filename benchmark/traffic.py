"""Traffic from a mix file and a seed: pure functions of (mix, seed), numpy only.

Every seed gets the same set of sizes and arrivals, drawn afresh in another
order: lengths are stratified (one draw in each of n equal-probability
strata of the mix's length distribution, jittered within the stratum by the
seed) and an open loop's request count is fixed by its rate and the window
(arrival times uniform over the window, which is a Poisson process given
its count).  So the work a window holds barely moves with the seed, and a
difference between two seeds' runs is the system's, not the traffic's.

Audio is N(0, sigma^2) noise: utterance i is a slice of one seeded noise
pool at a seeded offset (the codec does no data-dependent work, so what the
signal is does not matter; making each utterance anew would cost the host
more than the device's work).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

SEED_MASK = (1 << 64) - 1
_STREAMS = {"lengths": 1, "order": 2, "offsets": 3, "pool": 4, "arrivals": 5, "kinds": 6, "codes": 7, "sample": 8}


def rng(seed: int, stream: str, *extra: int) -> np.random.Generator:
    return np.random.default_rng([seed & SEED_MASK, _STREAMS[stream], *extra])


def stratified_lengths(dist: dict, n: int, seed: int, sample_rate: int, *extra: int) -> np.ndarray:
    """``n`` lengths in samples, one in each of ``n`` equal-probability strata of
    ``dist`` ({"kind": "uniform", "min_s", "max_s"} or {"kind": "lognormal",
    "median_s", "sigma", "min_s", "max_s"}: clipped), in seeded order."""
    u = (np.arange(n) + rng(seed, "lengths", *extra).random(n)) / n
    lo, hi = dist["min_s"], dist["max_s"]
    if dist["kind"] == "uniform":
        sec = lo + (hi - lo) * u
    elif dist["kind"] == "lognormal":
        # inverse CDF of the lognormal restricted to [lo, hi]
        from statistics import NormalDist

        nd = NormalDist(math.log(dist["median_s"]), dist["sigma"])
        a, b = nd.cdf(math.log(lo)), nd.cdf(math.log(hi))
        sec = np.exp([nd.inv_cdf(a + (b - a) * x) for x in u])
    else:
        raise ValueError(f"unknown length distribution {dist['kind']!r}")
    lens = np.round(np.asarray(sec) * sample_rate).astype(np.int64)
    return lens[rng(seed, "order", *extra).permutation(n)]


def noise_pool(mix: dict, seed: int, sample_rate: int) -> np.ndarray:
    n = int(mix["pool_seconds"] * sample_rate)
    return (rng(seed, "pool").standard_normal(n, dtype=np.float32) * np.float32(mix["noise_sigma"]))


def slices(pool: np.ndarray, lengths: np.ndarray, seed: int, *extra: int) -> List[np.ndarray]:
    offsets = (rng(seed, "offsets", *extra).random(len(lengths)) * (len(pool) - lengths + 1)).astype(np.int64)
    return [pool[o: o + n] for o, n in zip(offsets, lengths)]


# -- closed loop: batches of utterances ------------------------------------------

def offline_batch_lengths(mix: dict, seed: int, k: int, sample_rate: int) -> np.ndarray:
    """Batch ``k``'s utterance lengths (samples)."""
    return stratified_lengths(mix["length"], mix["batch_size"], seed, sample_rate, k)


def offline_batch(mix: dict, seed: int, k: int, pool: np.ndarray, sample_rate: int) -> List[np.ndarray]:
    return slices(pool, offline_batch_lengths(mix, seed, k, sample_rate), seed, k)


# -- open loop: requests ------------------------------------------------------------

def open_loop_requests(mix: dict, seed: int, seconds: float, sample_rate: int,
                       hop_samples: int) -> Dict[str, np.ndarray]:
    """The requests due in a window of ``seconds``: due offsets (s, sorted),
    kind (0 encode, 1 decode) and length in samples (decode: code frames x hop);
    request i's input is ``request_audio`` / ``request_codes`` of index i."""
    n = int(round(mix["rate_per_s"] * seconds))
    due = np.sort(rng(seed, "arrivals").random(n) * seconds)
    n_enc = int(round(n * mix["encode_share"]))
    kind = np.ones(n, np.int64)
    kind[:n_enc] = 0
    kind = kind[rng(seed, "kinds").permutation(n)]
    lens = stratified_lengths(mix["length"], n, seed, sample_rate)
    lens = np.where(kind == 1, np.maximum(lens // hop_samples, 1) * hop_samples, lens)
    return {"due": due, "kind": kind, "length": lens}


def request_audio(pool: np.ndarray, length: int, seed: int, i: int) -> np.ndarray:
    o = int(rng(seed, "offsets", i).integers(0, len(pool) - length + 1))
    return pool[o: o + length]


def request_codes(seed: int, i: int, groups: int, frames: int, levels_per_group: int) -> np.ndarray:
    return rng(seed, "codes", i).integers(0, levels_per_group, (groups, frames), dtype=np.int32)


def open_loop_sample(seed: int, kinds: np.ndarray, per_kind: int) -> np.ndarray:
    """Seeded indices of the requests whose answers are kept for the check: ``per_kind`` of each kind."""
    r = rng(seed, "sample")
    picks = [r.permutation(np.flatnonzero(kinds == k))[:per_kind] for k in (0, 1)]
    return np.sort(np.concatenate(picks))
