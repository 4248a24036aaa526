"""Closed loop: batches of utterances through ``AudioCodec.encode``, then
``AudioCodec.decode`` of the codes it returned, one batch after another.

The window runs from its start to the completion of the last batch started
in it; ``audio_x_realtime`` is the input audio seconds of those batches over
that time.  With ``--trace 1`` a profiler covers a few seconds of whole
batches from a third of the way in.  After the window the program is freed
and the reference checks one finished utterance of each row position of
the batch (the one of the lowest seeded priority among the window's
batches, so that a fault confined to one row is always seen), and the
longest finished utterance.
"""

from __future__ import annotations

import gc
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from benchmark import judge, traffic
from benchmark.cell import Run, log, peak_bytes, reset_peak
from benchmark.devtrace import DeviceTrace
from benchmark.loops import control_sides
from benchmark.reference import LowerPrecision, ReferenceCodec, float32_exact
from benchmark.spans import Recorder
from benchmark.weights import make_state

WARM_BATCH = 1 << 40  # the batch index of the warm-up inputs: never a timed batch's


def build_codec(run: Run, state):
    """The program: ``AudioCodec`` in the configuration's mode on the seed's weights."""
    from simwhisper_codec_tpu_torch.config import CodecConfig
    from simwhisper_codec_tpu_torch.models.codec import AudioCodec, SimWhisperCodec

    cfg = CodecConfig.from_dict(run.gp)
    with torch.device("meta"):
        model = SimWhisperCodec(cfg)
    model.load_state_dict(state, strict=True, assign=True)
    return AudioCodec(cfg, model, batch_size=run.mix["batch_size"], mode=run.config["mode"], device=run.device,
                      vocos_impl=run.config.get("vocos_impl"), aot_dir=str(run.aot_dir))


def round_trip(codec, wavs, overlap):
    with torch.profiler.record_function("bench.encode"):
        codes = codec.encode(wavs, overlap_seconds=overlap)["codes_list"]
    with torch.profiler.record_function("bench.decode"):
        return codes, codec.decode(codes, overlap_seconds=overlap)["syn_wav_list"]


def run(run: Run) -> None:
    mix, sr = run.mix, run.gp["input_sample_rate"]
    hop = run.gp["encoder_downsample_rate"]
    overlap = mix["overlap_seconds"]
    pool = traffic.noise_pool(mix, run.seed, sr)
    reset_peak(run.device)
    codec = build_codec(run, make_state(run.gp, run.seed, run.device))
    rec = run.recorder = Recorder()
    rec.wrap_codec(codec)
    warm = traffic.offline_batch(mix, run.seed, WARM_BATCH, pool, sr)
    for _ in range(2):  # the first call captures each program; the second replays
        round_trip(codec, warm, overlap)
    trace = DeviceTrace(run.tmpdir, run.device) if run.trace else None
    if trace is not None:
        trace.warm(lambda: round_trip(codec, warm, overlap))
    trace_at = run.seconds * mix["trace_start_share"]

    groups = run.gp["quantizer"]["num_groups"]
    per_row = {}  # row -> (priority, (k, row, wav, codes, out, batch_frames)): each row's lowest priority
    longest = None
    input_s = 0.0
    rec.active = True
    t0 = time.perf_counter()
    run.setup_s = run.elapsed_since_start()
    k = 0
    t_done = t0
    traced = False  # the profiler covers one sub-window
    paused = lambda: trace.paused_s if trace is not None else 0.0
    while t_done - t0 - paused() < run.seconds:
        if trace is not None and not traced and t_done - t0 >= trace_at:
            trace.start()
            rec.tracing, traced, t_trace = True, True, time.perf_counter()
        wavs = traffic.offline_batch(mix, run.seed, k, pool, sr)
        codes, outs = round_trip(codec, wavs, overlap)
        t_done = time.perf_counter()
        if rec.tracing and t_done - t_trace >= mix["trace_seconds"]:
            trace.stop()
            rec.tracing = False
        lens = np.array([len(w) for w in wavs])
        input_s += lens.sum() / sr
        run.attempted += len(wavs)
        frames = int((lens // hop).max())
        prio = traffic.rng(run.seed, "sample", k).random(len(wavs))
        for i, (w, c, y) in enumerate(zip(wavs, codes, outs)):
            n = len(w) // hop
            if c.shape != (groups, n) or y.shape != (n * hop,):
                run.failed += 1
            if i not in per_row or prio[i] < per_row[i][0]:
                per_row[i] = (prio[i], (k, i, w, c.copy(), y.copy(), frames))
            if longest is None or len(w) > len(longest[2]):
                longest = (k, i, w, c.copy(), y.copy(), frames)
        k += 1
    if rec.tracing:
        trace.stop()
        rec.tracing = False
    rec.active = False
    window = t_done - t0 - paused()
    run.end_to_end["audio_x_realtime"] = input_s / window
    run.counters.update(input_audio_s=input_s, window_s=window, batches=k)
    run.memory_peak_bytes = peak_bytes(run.device)
    if trace is not None:
        run.trace_summary = trace.summarise()
        log(f"trace: {run.trace_summary['host_s']:.6f} host s, range {run.trace_summary['window_s']:.6f} s, "
            f"busy {run.trace_summary['busy_s']:.6f} s; {trace.paused_s:.3f} s starting and stopping it, "
            "left out of the window")
    log(f"offline: {k} batches, {run.attempted} utterances, {input_s:.3f} input s in {window:.6f} s")

    del codec
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    checked = [item for _, item in sorted(per_row.values(), key=lambda e: e[1][1]) if item[:2] != longest[:2]]
    run.checked = [Checked(*it[2:]) for it in checked + [longest]]
    run.numbers = check(run.gp, run.seed, run.device, run.checked, overlap)
    run.numbers["shape_errors"] += run.failed
    run.numbers["low_precision_launches"] = float(
        judge.low_precision_launches(rec.program_calls, run.config["precision"]))


class Checked(NamedTuple):
    wav: np.ndarray  # the input
    codes: np.ndarray  # what encode returned
    out: np.ndarray  # what decode returned for those codes
    batch_frames: int  # the longest code length of its batch: its chunks' widths


def check(gp: dict, seed: int, device, items: Sequence[Checked], overlap: int, reference=None) -> dict:
    """The reference on the checked utterances: codes against its values
    before rounding, waveforms against its decode of the same codes at the
    same chunk widths.  ``reference``: a ``ReferenceCodec`` already made."""
    levels = gp["quantizer"]["num_levels_per_group"]
    groups, hop = gp["quantizer"]["num_groups"], gp["encoder_downsample_rate"]
    t0 = time.perf_counter()
    ref = reference or ReferenceCodec(gp, make_state(gp, seed, device))
    with torch.no_grad(), float32_exact():
        enc = ref.encode([it.wav for it in items], overlap)
        dec = ref.decode([it.codes for it in items], [it.batch_frames for it in items], overlap)
    gaps, errs, bad = [], [], 0
    for it, (_, lv), y in zip(items, enc, dec):
        n = len(it.wav) // hop
        if judge.shape_error(it.codes, (groups, n)) or judge.shape_error(it.out, (n * hop,)):
            bad += 1
            continue
        gaps.append(judge.code_gap(it.codes, lv, levels))
        errs.append(judge.wav_err(it.out, y))
    log(f"reference: {len(items)} utterances ({sum(len(it.wav) for it in items) / gp['input_sample_rate']:.1f} s) "
        f"in {time.perf_counter() - t0:.3f} s")
    return {"code_gap": max(gaps, default=float("nan")), "wav_err": max(errs, default=float("nan")),
            "shape_errors": float(bad)}


def control_offline(run: Run, exact: ReferenceCodec, formats: dict) -> dict:
    """The numbers of the reference with ``formats`` ({stage: format}) in the
    program's place, on the program's checked utterances: it encodes their
    inputs and decodes its own codes at the same chunk widths, and is
    compared with ``exact``; it launches no kernel."""
    ctrl = ReferenceCodec(run.gp, exact.p, LowerPrecision(formats))
    overlap = run.mix["overlap_seconds"]
    with torch.no_grad(), float32_exact():
        codes = [c for c, _ in ctrl.encode([it.wav for it in run.checked], overlap)]
        outs = ctrl.decode(codes, [it.batch_frames for it in run.checked], overlap)
    items = [Checked(it.wav, c.astype(np.int32), y, it.batch_frames) for it, c, y in zip(run.checked, codes, outs)]
    return dict(check(run.gp, run.seed, run.device, items, overlap, reference=exact), low_precision_launches=0.0)


def controls(run: Run, config: dict, sides=None) -> dict:
    """{side: numbers} of the reference one format lower in the program's place (``control_sides``)."""
    exact = ReferenceCodec(run.gp, make_state(run.gp, run.seed, run.device))
    return {side: control_offline(run, exact, formats) for side, formats in control_sides(config, sides).items()}
