"""Closed loop of SIM scoring: ``SpeakerEmbedder.embed_batch`` calls, one after another.

Each call embeds a codec test set's pairs, both rows of each: an utterance
(a slice of the seeded noise pool) and its stand-in resynthesis, of the
same length (the same slice of a second pool, the first plus seeded
noise), in seeded order; the pair cosines are computed as SIM does.  The
lengths are stratified (the mix's distribution, one draw a stratum a call),
and each stratum's draws are stratified over the calls (``call_lengths``):
every seed's calls run the same programs, and the calls that reach the
64 s bucket are the same on every seed.
The configuration's ``precision`` sets the program's: every stage f32 runs
``precision="highest"`` (TF32 off), every stage TF32 ``"default"``.

The window runs from its start to the completion of the last call started
in it; ``audio_x_realtime`` is the input audio seconds of those calls'
rows over that time.  The warm-up embeds, twice (the first round captures
each signature's program, the second replays), rows of every
power-of-two-second bucket the mix reaches in every power-of-two count the
program groups them in, so that nothing is captured in the window.  With
``--trace 1`` a profiler covers a few seconds of whole calls from a third
of the way in.

After the window the program is freed and the plain reference embeds,
each alone at its exact length: a seeded sample of the window's rows, the
row of lowest seeded priority of each bucket that ran, the longest row of a
group the program padded with empty rows, and the longest row of the window.
"""

from __future__ import annotations

import gc
import math
import os
import time
from statistics import NormalDist
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from benchmark import judge, speaker_yardstick, traffic
from benchmark.cell import Run, log, peak_bytes, reset_peak
from benchmark.devtrace import DeviceTrace
from benchmark.reference_speaker import ReferenceSpeaker
from benchmark.speaker_weights import make_state

SAMPLE_RATE = 16000
GOLDEN = (math.sqrt(5) - 1) / 2
# the top stratum's offset: its draws in calls 2, 10, 18, 23 pass 32 s, 3 of the 19 to
# 23 calls that a window holds at about 370 x real time (14.7 % of draws expected)
TOP_OFFSET = 0.75


class Checked(NamedTuple):
    wav: np.ndarray  # the input row
    emb: np.ndarray  # what embed_batch returned for it


class Row(NamedTuple):
    call: int
    index: int  # position in its call
    samples: int
    bucket: int
    priority: float
    padded: bool  # the longest row of a bucket that the program padded in its call


def embedder_precision(precision: dict) -> str:
    """The program's ``precision`` for a configuration's {stage: format}."""
    formats = set(precision.values())
    if formats == {"f32"}:
        return "highest"
    if formats == {"tf32"}:
        return "default"
    raise ValueError(f"the program runs every stage in f32 or every stage in tf32, not {precision}")


def build_embedder(run: Run, state: dict):
    """The program as a user loads it: the state dict written as the published
    file (``{"model": sd}``), read by ``SpeakerEmbedder.from_checkpoint``."""
    from simwhisper_codec_tpu_torch.eval.speaker import SpeakerEmbedder

    path = os.path.join(run.tmpdir, f"bench-speaker-{os.getpid()}.pth")
    try:
        torch.save({"model": state}, path)
        return SpeakerEmbedder.from_checkpoint(path, device=run.device,
                                               precision=embedder_precision(run.config["precision"]))
    finally:
        if os.path.exists(path):
            os.remove(path)


def pools(mix: dict, seed: int):
    """The utterances' noise pool and the resyntheses' (the first plus N(0, resynthesis_sigma^2))."""
    pool = traffic.noise_pool(mix, seed, SAMPLE_RATE)
    noise = traffic.rng(seed, "pool", 1).standard_normal(len(pool), dtype=np.float32)
    return pool, pool + noise * np.float32(mix["resynthesis_sigma"])


def call_lengths(dist: dict, n: int, seed: int, k: int) -> np.ndarray:
    """Call ``k``'s ``n`` lengths in samples, one in each of ``n``
    equal-probability strata of the clipped lognormal ``dist``, in seeded
    order.  Stratum i's place within it is (offset_i + k x the golden ratio)
    mod 1: over any run of calls each stratum's draws spread evenly.  The
    offsets are seeded, but for the strata that straddle the edge of a
    power-of-two-second bucket: theirs are fixed (``TOP_OFFSET`` for the top
    stratum, then a golden-ratio step a stratum down), so that every seed's
    calls run the same programs, call by call."""
    if dist["kind"] != "lognormal":
        raise ValueError(f"call_lengths draws a lognormal, not {dist['kind']!r}")
    nd = NormalDist(math.log(dist["median_s"]), dist["sigma"])
    a, b = nd.cdf(math.log(dist["min_s"])), nd.cdf(math.log(dist["max_s"]))
    seconds = lambda u: np.exp([nd.inv_cdf(a + (b - a) * x) for x in u])  # noqa: E731
    edges, powers = seconds(np.arange(n + 1) / n), 2.0 ** np.arange(12)
    fixed = np.nonzero(((edges[:-1, None] < powers) & (powers < edges[1:, None])).any(axis=1))[0]
    offset = traffic.rng(seed, "lengths").random(n)
    offset[fixed] = (TOP_OFFSET + (n - 1 - fixed) * GOLDEN) % 1.0
    u = (np.arange(n) + (offset + k * GOLDEN) % 1.0) / n
    lens = np.round(seconds(u) * SAMPLE_RATE).astype(np.int64)
    return lens[traffic.rng(seed, "order", k).permutation(n)]


def call_rows(mix: dict, seed: int, k: int, pool_pair) -> tuple:
    """Call ``k``'s rows in seeded order, and ``order``: row i is side ``order[i] % 2`` of pair ``order[i] // 2``."""
    lens = call_lengths(mix["length"], mix["pairs_per_call"], seed, k)
    sides = [traffic.slices(p, lens, seed, k) for p in pool_pair]
    order = traffic.rng(seed, "order", k, 1).permutation(2 * len(lens))
    return [sides[i % 2][i // 2] for i in order], order


def pair_cosines(emb: np.ndarray, order: np.ndarray) -> np.ndarray:
    where = np.argsort(order)
    a, b = emb[where[0::2]].astype(np.float64), emb[where[1::2]].astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)


def warm_rows(mix: dict, pool: np.ndarray) -> List[np.ndarray]:
    """One row of every power-of-two-second bucket between the mix's shortest and longest rows."""
    lo, hi = (round(mix["length"][k] * SAMPLE_RATE) for k in ("min_s", "max_s"))
    bucket, rows = SAMPLE_RATE, []
    while bucket < lo:
        bucket *= 2
    while True:
        rows.append(pool[: min(bucket, hi)])
        if bucket >= hi:
            return rows
        bucket *= 2


def warm_calls(mix: dict, pool: np.ndarray, max_rows: int) -> List[List[np.ndarray]]:
    """Calls that meet every signature the window can: each bucket's row
    ``n`` times, for each power of two ``n`` below ``max_rows`` and for ``max_rows``."""
    counts = sorted({1 << i for i in range(max_rows.bit_length()) if 1 << i < max_rows} | {max_rows})
    return [[w for w in warm_rows(mix, pool) for _ in range(n)] for n in counts]


def call_row_records(embedder, k: int, wavs: Sequence[np.ndarray], seed: int) -> List[Row]:
    from simwhisper_codec_tpu_torch.eval.speaker import MIN_SAMPLES, wavlm_groups

    bucket, padded = {}, set()
    for b, rows, idx in wavlm_groups(np.array([max(len(w), MIN_SAMPLES) for w in wavs]), embedder.max_rows):
        bucket.update((int(i), b) for i in idx)
        if len(idx) < rows:  # its longest row: the program sorts the rows by length
            padded.add(int(idx[-1]))
    prio = traffic.rng(seed, "sample", k).random(len(wavs))
    return [Row(k, i, len(w), bucket[i], float(prio[i]), i in padded) for i, w in enumerate(wavs)]


def run(run: Run) -> None:
    from simwhisper_codec_tpu_torch.eval.speaker import SpeakerEmbedder

    if not hasattr(SpeakerEmbedder, "embed_batch"):
        raise RuntimeError("the program has no SpeakerEmbedder.embed_batch: it cannot run this cell")
    mix, arch = run.mix, run.config["wavlm_ecapa"]
    pool_pair = pools(mix, run.seed)
    reset_peak(run.device)
    embedder = build_embedder(run, make_state(arch, run.seed, run.device))
    warm = warm_calls(mix, pool_pair[0], embedder.max_rows)
    for _ in range(2):  # the first round captures each signature's program; the second replays
        for rows in warm:
            embedder.embed_batch(rows)
    trace = DeviceTrace(run.tmpdir, run.device) if run.trace else None
    if trace is not None:
        trace.warm(lambda: embedder.embed_batch(warm[-1]))
    trace_at = run.seconds * mix["trace_start_share"]

    rows: List[Row] = []
    embs: List[np.ndarray] = []
    sims = []
    t0 = time.perf_counter()
    run.setup_s = run.elapsed_since_start()
    k, t_done, tracing, traced = 0, t0, False, False
    paused = lambda: trace.paused_s if trace is not None else 0.0  # noqa: E731
    while t_done - t0 - paused() < run.seconds:
        if trace is not None and not traced and t_done - t0 >= trace_at:
            trace.start()
            tracing, traced, t_trace = True, True, time.perf_counter()
        wavs, order = call_rows(mix, run.seed, k, pool_pair)
        with torch.profiler.record_function("bench.embed"):
            emb = embedder.embed_batch(wavs)
        t_done = time.perf_counter()
        if tracing and t_done - t_trace >= mix["trace_seconds"]:
            trace.stop()
            tracing = False
        run.attempted += len(wavs)
        if emb.shape != (len(wavs), arch["embedding_dim"]) or not np.isfinite(emb).all():
            run.failed += len(wavs)
        else:
            sims.append(pair_cosines(emb, order))
        rows += call_row_records(embedder, k, wavs, run.seed)
        embs.append(emb)
        k += 1
    if tracing:
        trace.stop()
    window = t_done - t0 - paused()
    input_s = sum(r.samples for r in rows) / SAMPLE_RATE
    flops = sum(speaker_yardstick.utterance_total(arch, r.samples) for r in rows)
    run.end_to_end["audio_x_realtime"] = input_s / window
    run.counters.update(input_audio_s=input_s, input_flops=float(flops), window_s=window, calls=k)
    run.memory_peak_bytes = peak_bytes(run.device)
    if trace is not None:
        run.trace_summary = trace.summarise()
        log(f"trace: {run.trace_summary['host_s']:.6f} host s, range {run.trace_summary['window_s']:.6f} s, "
            f"busy {run.trace_summary['busy_s']:.6f} s; {trace.paused_s:.3f} s starting and stopping it, "
            "left out of the window")
    sim = float(np.mean(np.concatenate(sims))) if sims else float("nan")
    log(f"speaker: {k} calls, {run.attempted} rows, {input_s:.3f} input s in {window:.6f} s; mean SIM {sim:.4f}")

    del embedder
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    picked = checked_rows(rows, mix["check_rows"], run.seed)
    run.checked = [Checked(call_rows(mix, run.seed, r.call, pool_pair)[0][r.index], embs[r.call][r.index])
                   for r in picked]
    run.numbers = check(arch, run.seed, run.device, run.checked)
    run.numbers["shape_errors"] += run.failed


def checked_rows(rows: List[Row], sample: int, seed: int) -> List[Row]:
    """A seeded sample, each bucket's row of lowest priority, a padded group's, the longest; each once."""
    picked = [rows[i] for i in traffic.rng(seed, "sample").permutation(len(rows))[:sample]]
    for b in sorted({r.bucket for r in rows}):
        picked.append(min((r for r in rows if r.bucket == b), key=lambda r: r.priority))
    padded = [r for r in rows if r.padded]
    if padded:
        picked.append(min(padded, key=lambda r: r.priority))
    picked.append(max(rows, key=lambda r: r.samples))
    return list(dict.fromkeys(picked))


def check(arch: dict, seed: int, device, items: Sequence[Checked], reference=None) -> dict:
    """The reference on the checked rows, each alone at its exact length:
    ``emb_err`` the largest relative L2 error of an embedding,
    ``shape_errors`` the embeddings of a wrong shape or not finite."""
    t0 = time.perf_counter()
    ref = reference or ReferenceSpeaker(make_state(arch, seed, device), arch)
    errs, bad = [], 0
    for it in items:
        want = ref.embed(it.wav)
        if judge.shape_error(it.emb, want.shape):
            bad += 1
            continue
        errs.append(judge.wav_err(it.emb, want))
    log(f"reference: {len(items)} rows ({sum(len(it.wav) for it in items) / SAMPLE_RATE:.1f} s) "
        f"in {time.perf_counter() - t0:.3f} s")
    return {"emb_err": max(errs, default=float("nan")), "shape_errors": float(bad)}


def controls(run: Run, config: dict, sides=None) -> dict:
    """{side: numbers} of the reference in the program's place on the checked rows,
    against the exact reference: ``control`` with the stages' products in the
    formats of the configuration's ``control`` (TF32), ``control.<name>`` with
    each of its ``stage_controls`` (``gate``: False fixes the gate at 1)."""
    arch = config["wavlm_ecapa"]
    variants = {"control": {"formats": config["control"]},
                **{f"control.{k}": v for k, v in config.get("stage_controls", {}).items()}}
    state = make_state(arch, run.seed, run.device)
    exact = ReferenceSpeaker(state, arch)
    out = {}
    for side, v in variants.items():
        if sides is not None and side not in sides:
            continue
        ctrl = ReferenceSpeaker(state, arch, formats=v.get("formats", config["precision"]), gate=v.get("gate", True))
        items = [Checked(it.wav, ctrl.embed(it.wav)) for it in run.checked]
        out[side] = check(arch, run.seed, run.device, items, reference=exact)
    return out
