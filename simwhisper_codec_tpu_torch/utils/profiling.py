"""Tracing, spans and per-stage timing on ``torch.profiler`` (counterpart of
the JAX package's ``utils/profiling.py``).

 - ``annotate(name, **attrs)``: a span.  It appends one closed record
   (``Span``: name, thread, start and end, attrs, ``profiled``) to a
   bounded, process-wide log, from any thread; while a profiler session
   runs it is also a ``record_function`` range, which the profiler keeps
   only on the thread that started the session.  Times are Unix
   nanoseconds on the axis of a Chrome trace's ``baseTimeNanoseconds``,
   durations from the monotonic clock.  Without a session a span costs
   two clock reads and an append.  ``record`` adds a span whose edges
   were read earlier (``clock_ns``); ``spans(since_ns)`` and ``dropped()``
   read the log;
 - ``trace(logdir)``: context manager that profiles CPU and CUDA activity
   and writes a TensorBoard-loadable trace
   (``<host>_<pid>.<ns>.pt.trace.json``, Chrome trace format) under
   ``logdir``, with the log's spans of its interval merged in: each
   thread's spans on a row of its own under a ``program spans`` process,
   on the trace's clock, so that the micro-batcher's spans sit beside the
   kernels they launched;
 - ``StageTimer``: wall-clock stage accounting that synchronises the CUDA
   device of the result it is given before it stops the clock, for
   tokenize / detokenize breakdowns.

The merged trace is the operator's view of the log; the benchmark's
per-layer metrics read the log in process (``spans``).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import socket
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger(__name__)


# Unix ns at perf_counter_ns() == 0: one anchor pair, so that spans keep the
# monotonic clock's durations on the wall clock's axis
_ANCHOR_NS = time.time_ns() - time.perf_counter_ns()


def clock_ns() -> int:
    """Now, on the spans' axis (Unix nanoseconds)."""
    return _ANCHOR_NS + time.perf_counter_ns()


def profiler_enabled() -> bool:
    """Whether a profiler session runs (a process-wide flag every thread sees)."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


class Span(NamedTuple):
    name: str
    thread: int  # threading.get_ident() of the thread that closed it
    start_ns: int
    end_ns: int
    attrs: dict
    profiled: bool  # a profiler session ran when it began


class SpanLog:
    """The newest ``maxlen`` spans; ``dropped`` counts the older ones pushed out.
    Records are kept as plain tuples (cheaper to make) and read as ``Span``s."""

    def __init__(self, maxlen: int):
        self._records: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self.dropped = 0

    def append(self, record: tuple) -> None:
        with self._lock:
            if len(self._records) == self._records.maxlen:
                self.dropped += 1
            self._records.append(record)

    def spans(self, since_ns: Optional[int] = None) -> List[Span]:
        with self._lock:
            kept = list(self._records)
        return [Span._make(r) for r in kept if since_ns is None or r[2] >= since_ns]


# 4 x the busiest benchmark window (the serving cell: ~3.3 k requests and
# ~1.3 k micro-batches of ~15 spans in 51 s); ~50 MB when full
_log = SpanLog(1 << 17)


def spans(since_ns: Optional[int] = None) -> List[Span]:
    """The log's spans, oldest closed first; with ``since_ns`` those that began then or later."""
    return _log.spans(since_ns)


def dropped() -> int:
    """Spans the log has pushed out since the process started."""
    return _log.dropped


def record(name: str, start_ns: int, end_ns: int, profiled: bool = False, **attrs) -> None:
    """Add a span whose edges were read with ``clock_ns`` (possibly on another thread)."""
    _log.append((name, threading.get_ident(), start_ns, end_ns, attrs, profiled))


class _Annotation:
    __slots__ = ("name", "attrs", "_profiled", "_range", "_start")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> dict:
        self._profiled = profiler_enabled()
        self._range = None
        if self._profiled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._start = time.perf_counter_ns()
        return self.attrs

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _log.append((self.name, threading.get_ident(), _ANCHOR_NS + self._start, _ANCHOR_NS + end,
                     self.attrs, self._profiled))


def annotate(name: str, **attrs) -> _Annotation:
    """A span around a ``with`` block (see the module docstring); the block gets
    ``attrs``, a dict it may add to."""
    return _Annotation(name, attrs)


def _merge_spans(path: str, since_ns: int, until_ns: int) -> None:
    """Add the log's spans that began in [since_ns, until_ns] to the Chrome trace
    at ``path``: a ``program spans`` process, one row a thread."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid() + (1 << 22)  # above Linux's largest pid: a row group of its own
    threads = {t.ident: t for t in threading.enumerate()}
    events = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
               "args": {"name": f"program spans (pid {os.getpid()})"}}]
    rows = {}
    for s in spans(since_ns):
        if s.start_ns > until_ns:
            continue
        if s.thread not in rows:
            t = threads.get(s.thread)
            rows[s.thread] = t.native_id if t is not None and t.native_id is not None else len(rows) + 1
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": rows[s.thread],
                           "args": {"name": t.name if t is not None else f"thread {s.thread}"}})
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": rows[s.thread],
                       "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": dict(s.attrs, profiled=s.profiled)})
    doc["traceEvents"].extend(events)
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile CPU and (when present) CUDA activity; the trace, with the span
    log's spans of the interval merged in, lands under ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    since = clock_ns()
    with profile(activities=activities) as prof:
        yield
    until = clock_ns()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(str(logdir), f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    _merge_spans(path, since, until)
    logger.info("profiler trace written to %s", path)


def _cuda_devices(x, out: set) -> set:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    return out


def block_until_ready(x):
    """Wait for the CUDA devices that hold ``x`` (a tensor, or dicts, lists
    and tuples of them) to finish their queued work; returns ``x``."""
    for device in _cuda_devices(x, set()):
        torch.cuda.synchronize(device)
    return x


class StageTimer:
    """Accumulating wall-clock timer with optional device sync per stage."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        start = time.perf_counter()
        yield
        if self.sync and block_on is not None:
            block_until_ready(block_on)
        self.totals[name] += time.perf_counter() - start
        self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.totals.values())
        lines = [f"{'stage':<16}{'total_s':>10}{'calls':>8}{'share':>8}"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t = self.totals[name]
            lines.append(
                f"{name:<16}{t:>10.3f}{self.counts[name]:>8}{100*t/max(total,1e-9):>7.1f}%"
            )
        lines.append(f"{'(sum)':<16}{total:>10.3f}")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
