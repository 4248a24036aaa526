"""The readers of the program's own spans (``program_spans.py``), on a CPU run of
each loop at narrow widths: each reads a finite value, and the program's
counts equal the harness's, so that its spans can stand in for the harness's
wrappers: the tokenize programs' rows x samples (``computed_per_input``'s
numerator) and the micro-batches' requests (``batch_requests.serve``)."""

import importlib
import math
from types import SimpleNamespace

import pytest

from benchmark import cell, program_spans, readers
from tiny import tiny_run

READERS = {"offline": ["host_ms.encode.offline", "host_ms.decode.offline"],
           "http_open_loop": ["host_ms.batch.serve", "queue_wait_ms.serve"]}


@pytest.mark.parametrize("workload", ["codec-int8.offline-long", "codec-int8.serve-short"])
def test_the_program_spans_read_finite_values_and_the_harness_counts(workload):
    manifest, run = tiny_run(workload, seed=2**31 + 1901, seconds=3.0)
    loop = run.mix["loop"]
    importlib.import_module(f"benchmark.loops.{loop}").run(run)
    reported = {e["name"] for e in cell.per_layer_entries(manifest, workload)}
    for name in READERS[loop]:
        assert name in reported
        value = cell.metric_reader(name)(run)
        assert value is not None and math.isfinite(value) and value >= 0.0, (name, value)
    spans = program_spans.window(run)
    if loop == "offline":
        calls = [s for s in spans if s.name == "codec.tokenize.program"]
        assert len(calls) == sum(c["direction"] == "tokenize" for c in run.recorder.program_calls) > 0
        samples = sum(s.attrs["rows"] * s.attrs["samples"] for s in calls)
        assert samples / run.gp["input_sample_rate"] == readers.tokenized_audio_s(run)
    else:
        batches = [s for s in spans if s.name == "serve.batch"]
        assert len(batches) == len(run.recorder.runner_calls) > 0
        assert sum(s.attrs["requests"] for s in batches) == sum(c["requests"] for c in run.recorder.runner_calls)
        # every request that reached the micro-batcher (none refused in a sound run) waited in its queue once
        assert sum(s.name == "serve.queue" for s in spans) == run.attempted - run.counters["refused"]


def fake_run(seconds=10.0):
    return SimpleNamespace(t_start=100.0, setup_s=5.0, seconds=seconds)


def test_a_program_without_a_span_log_reads_nothing(monkeypatch):
    """The parent of the program's spans has no log: every reader gives None, and none raises."""
    from simwhisper_codec_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert program_spans.window(fake_run()) is None
    for names in READERS.values():
        for name in names:
            assert cell.metric_reader(name)(fake_run()) is None


def test_a_log_that_may_have_dropped_inside_the_window_reads_nothing(monkeypatch):
    """Records close in order: one pushed out ended before the oldest kept. Where
    that one ended inside the window (from 105 s), a dropped record may have begun there."""
    from simwhisper_codec_tpu_torch.utils import profiling

    log = profiling.SpanLog(3)
    monkeypatch.setattr(profiling, "_log", log)
    s = 10**9
    for start in (100 * s, 102 * s, 106 * s, 107 * s):
        log.append(("serve.queue", 1, start, start + s // 2, {"kind": "encode"}, False))
    assert log.dropped == 1 and [x.start_ns for x in program_spans.window(fake_run())] == [106 * s, 107 * s]
    log.append(("serve.queue", 1, 108 * s, 108 * s + 1, {"kind": "encode"}, False))
    assert program_spans.window(fake_run()) is None


def test_contained_sums_keep_to_the_thread_and_leave_out_profiled_calls():
    from simwhisper_codec_tpu_torch.utils.profiling import Span

    def span(name, a, b, profiled=False, thread=1):
        return Span(name, thread, a, b, {}, profiled)

    spans = [span("codec.encode", 0, 100), span("codec.tokenize.host", 0, 10), span("codec.tokenize.program", 10, 20),
             span("codec.tokenize.host", 20, 50), span("codec.tokenize.host", 60, 70, thread=2),
             span("codec.encode", 200, 300), span("codec.tokenize.host", 200, 210, profiled=True),
             span("codec.encode", 400, 500, profiled=True)]
    assert program_spans.contained_ns(spans, "codec.encode", program_spans.is_host) == [40]
