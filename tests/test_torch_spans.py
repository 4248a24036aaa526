"""The port's span log (``utils/profiling.py``) and the spans the serving path
records, on the CPU:

 - spans nest, carry attrs, come from any thread, and the bounded log counts
   what it drops, also under many writers;
 - without a profiler session no ``record_function`` is made;
 - ``trace`` merges the log into its Chrome trace: a second thread's spans on
   a row of their own, a main-thread span within 1 ms of its own range;
 - a TINY ``AudioCodec``'s ``encode`` / ``decode`` spans are tiled by their
   host, program and fetch children, whose rows x samples (frames) are what
   the programs got;
 - ``MicroBatcher`` closes one ``serve.queue`` span a request and counts its
   runner calls in ``stats()["batches"]``.
"""

import glob
import json
import sys
import threading
import time

import numpy as np
import torch

from simwhisper_codec_tpu_torch.config import (CodecConfig, DecoderConfig, EncoderConfig, SampleStackConfig,
                                               VocosConfig)
from simwhisper_codec_tpu_torch.models.codec import AudioCodec, init_params
from simwhisper_codec_tpu_torch.serve import MicroBatcher
from simwhisper_codec_tpu_torch.utils import profiling

# the published generator at width 64, two layers a tower (tests/test_parallel.py's TINY)
TINY = CodecConfig(
    acoustic_encoder=EncoderConfig(d_model=64, encoder_layers=2, encoder_attention_heads=4, encoder_ffn_dim=128),
    acoustic_decoder=DecoderConfig(d_model=64, decoder_layers=2, decoder_attention_heads=4, decoder_ffn_dim=128),
    downsample=SampleStackConfig(in_dim=64, latent_dim=32, stack_factor=4, hidden_dim=48),
    upsample=SampleStackConfig(out_dim=64, latent_dim=32, stack_factor=4, hidden_dim=48),
    vocos=VocosConfig(input_channels=80, dim=64, intermediate_dim=128, num_layers=2),
)


def named(spans, *names):
    return [s for s in spans if s.name in names]


def test_spans_nest_and_carry_attrs():
    since = profiling.clock_ns()
    with profiling.annotate("test.outer", rows=2) as attrs:
        with profiling.annotate("test.inner", step="pack"):
            time.sleep(0.001)
        attrs["chunks"] = 3
    inner, outer = named(profiling.spans(since), "test.outer", "test.inner")  # in the order they closed
    assert (inner.name, outer.name) == ("test.inner", "test.outer")
    assert since <= outer.start_ns <= inner.start_ns < inner.end_ns <= outer.end_ns <= profiling.clock_ns()
    assert inner.end_ns - inner.start_ns >= 1_000_000
    assert outer.attrs == {"rows": 2, "chunks": 3} and inner.attrs == {"step": "pack"}
    assert inner.thread == outer.thread == threading.get_ident()
    assert not outer.profiled and not inner.profiled


def test_a_second_threads_spans_are_kept():
    since = profiling.clock_ns()
    idents = []

    def work():
        idents.append(threading.get_ident())
        with profiling.annotate("test.second_thread", n=1):
            pass

    th = threading.Thread(target=work)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    (span,) = named(profiling.spans(since), "test.second_thread")
    assert span.thread == idents[0] != threading.get_ident() and span.attrs == {"n": 1}


def test_the_log_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "_log", profiling.SpanLog(4))
    for i in range(10):
        with profiling.annotate("test.bounded", i=i):
            pass
    profiling.record("test.recorded", 5, 7, True, kind="encode")
    kept = profiling.spans()
    assert [s.attrs.get("i") for s in kept] == [7, 8, 9, None] and profiling.dropped() == 7
    assert kept[-1] == profiling.Span("test.recorded", threading.get_ident(), 5, 7, {"kind": "encode"}, True)
    assert [s.attrs.get("i") for s in profiling.spans(since_ns=kept[1].start_ns)] == [8, 9]


def test_the_log_loses_no_count_under_many_writers(monkeypatch):
    monkeypatch.setattr(profiling, "_log", profiling.SpanLog(1000))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(500):
                with profiling.annotate("test.stress"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(profiling.spans()) == 1000 and profiling.dropped() == 16 * 500 - 1000


def test_no_record_function_without_a_profiler_session(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function made without a profiler session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not profiling.profiler_enabled()
    since = profiling.clock_ns()
    with profiling.annotate("test.unprofiled"):
        pass
    (span,) = named(profiling.spans(since), "test.unprofiled")
    assert not span.profiled


def test_trace_merges_the_log_on_its_clock(tmp_path):
    def work():
        with profiling.annotate("test.trace.batcher", kind="encode"):
            time.sleep(0.002)

    with profiling.trace(str(tmp_path)):
        th = threading.Thread(target=work, name="test-batcher")
        th.start()
        th.join(timeout=30)
        with profiling.annotate("test.trace.main"):
            torch.relu(torch.randn(256, 256) @ torch.randn(256, 256))
            time.sleep(0.005)
    assert not th.is_alive()
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    (batcher,) = [e for e in events if e["name"] == "test.trace.batcher"]
    assert batcher["cat"] == "program_span" and batcher["args"]["kind"] == "encode" and batcher["args"]["profiled"]
    ranges = [e for e in events if e["name"] == "test.trace.main" and e.get("cat") == "user_annotation"]
    (mine,) = [e for e in events if e["name"] == "test.trace.main" and e.get("cat") == "program_span"]
    (rng,) = ranges
    assert abs(mine["ts"] - rng["ts"]) < 1000 and abs(mine["ts"] + mine["dur"] - rng["ts"] - rng["dur"]) < 1000
    # the program's rows are their own: no profiler event shares them
    rows = {(e["pid"], e["tid"]) for e in events if e.get("cat") == "program_span"}
    assert (batcher["pid"], batcher["tid"]) != (mine["pid"], mine["tid"])
    assert not rows & {(e["pid"], e["tid"]) for e in events if e.get("cat") != "program_span"}


class Spy:
    """A serving program that notes the input shape of each call."""

    def __init__(self, program, shapes):
        self._program, self.shapes = program, shapes

    def __getattr__(self, name):
        return getattr(self._program, name)

    def __call__(self, *args):
        self.shapes.append(tuple(args[0].shape))
        return self._program(*args)


def children(spans, parent):
    return sorted((s for s in spans if s.thread == parent.thread and s is not parent
                   and parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns), key=lambda s: s.start_ns)


def test_codec_spans_tile_encode_and_decode():
    torch.manual_seed(0)
    codec = AudioCodec(TINY, init_params(TINY), batch_size=2, mode="parity", device="cpu")
    tok, detok = [], []
    codec._tokenize, codec._detokenize = Spy(codec._tokenize, tok), Spy(codec._detokenize, detok)
    rng = np.random.default_rng(0)
    wavs = [0.1 * rng.standard_normal(n).astype(np.float32) for n in (35 * 16000, 12 * 16000)]
    since = profiling.clock_ns()
    codes = codec.encode(wavs)["codes_list"]
    codec.decode(codes)
    got = profiling.spans(since)
    for direction, program, inputs, width in (("encode", "tokenize", tok, "samples"),
                                              ("decode", "detokenize", detok, "frames")):
        (parent,) = named(got, f"codec.{direction}")
        inner = children(got, parent)
        assert {s.name for s in inner} == {f"codec.{program}.{k}" for k in ("host", "program", "fetch")}
        assert {s.attrs["step"] for s in inner if s.name.endswith(".host")} == {"pack", "stage", "unpack"}
        assert all(a.end_ns <= b.start_ns for a, b in zip(inner, inner[1:])), "children overlap"
        covered = sum(s.end_ns - s.start_ns for s in inner)
        assert covered >= 0.95 * (parent.end_ns - parent.start_ns)
        programs = named(inner, f"codec.{program}.program")
        assert parent.attrs == {"rows": 2, "chunks": 2} and len(programs) == 2
        assert all(s.attrs["source"] == "eager" for s in programs)
        # rows x samples (tokenize) or frames (detokenize): what the programs got
        shapes = [(s[0], s[1]) if program == "tokenize" else (s[1], s[2]) for s in inputs]
        assert [(s.attrs["rows"], s.attrs[width]) for s in programs] == shapes


def test_micro_batcher_spans_each_request_and_counts_batches():
    batcher = MicroBatcher(lambda kind, payloads: payloads, max_batch=4, window_ms=50.0)
    since = profiling.clock_ns()
    results, kinds = {}, ["encode", "decode"] * 3

    def submit(i):
        results[i] = batcher.submit(kinds[i], i)

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads) and results == {i: i for i in range(6)}
    got = profiling.spans(since)
    queued = named(got, "serve.queue")
    assert len(queued) == 6 and all(s.end_ns >= s.start_ns >= since for s in queued)
    assert sorted(s.attrs["kind"] for s in queued) == sorted(kinds)
    batches = named(got, "serve.batch")
    assert batcher.stats()["batches"] == len(batches) >= 2 and batcher.stats()["served"] == 6
    assert sum(s.attrs["requests"] for s in batches) == 6
    assert {s.thread for s in queued + batches + named(got, "serve.collect")} == {queued[0].thread}
