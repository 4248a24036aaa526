"""A ``torch.profiler`` trace of a short sub-window, reduced to what the metrics read.

``DeviceTrace.start`` / ``stop`` bracket the sub-window (each after a
device synchronise) inside a ``bench.trace_window`` range; the trace is
exported to the run's temporary directory, read, and deleted.  The
summary holds:

- ``window_s``: the sub-window's length; ``busy_s``: the union of the
  device's kernels, copies and sets inside it;
- ``kernels``: device seconds and count by kernel name;
- ``ranges``: for each ``bench.*`` range name, its calls and the device
  seconds of the work those calls launched (by the profiler's correlation
  of each kernel with the runtime call that launched it: a CUDA-graph
  replay's kernels carry its ``cudaGraphLaunch``);
- ``idle_gaps``: the device's idle time inside the window, by the innermost
  ``bench.*`` range the host was in at each gap's midpoint.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from benchmark.cell import synchronize

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "outside the harness's ranges"


class DeviceTrace:
    """``warm`` once in set-up (the profiler's first session pays its own start-up),
    then ``start`` / ``stop`` around the sub-window, and ``summarise`` after the
    measured window (exporting and reading the trace takes seconds)."""

    def __init__(self, tmpdir: str, device):
        self.path = os.path.join(tmpdir, f"bench-trace-{os.getpid()}.json")
        self.device = device
        self._prof = None
        self._range = None
        self.host_s = 0.0
        self.paused_s = 0.0  # host seconds spent starting and stopping the profiler

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        return profile(activities=activities)

    def warm(self, fn) -> None:
        with self._profile():
            fn()
            synchronize(self.device)

    def start(self) -> None:
        t0 = time.perf_counter()
        synchronize(self.device)
        self._prof = self._profile()
        self._prof.__enter__()
        self._range = torch.profiler.record_function("bench.trace_window")
        self._range.__enter__()
        self._t0 = time.perf_counter()
        self.paused_s += self._t0 - t0

    def stop(self) -> None:
        synchronize(self.device)
        t1 = time.perf_counter()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.host_s = t1 - self._t0
        self.paused_s += time.perf_counter() - t1

    def summarise(self) -> dict:
        try:
            self._prof.export_chrome_trace(self.path)
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            if os.path.exists(self.path):
                os.remove(self.path)
        summary = summarise(events)
        summary["host_s"] = self.host_s
        return summary


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarise(events: List[dict]) -> dict:
    """The sub-window's summary from chrome-trace events (times in microseconds)."""
    xs = [e for e in events if e.get("ph") == "X"]
    windows = [e for e in xs if e.get("name") == "bench.trace_window" and e.get("cat") == "user_annotation"]
    if not windows:
        raise RuntimeError("the trace has no bench.trace_window range")
    w0 = windows[0]["ts"]
    w1 = w0 + windows[0]["dur"]
    device = [e for e in xs if e.get("cat") in DEVICE_CATS and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    if not device:
        raise RuntimeError("the trace holds no device activity")
    busy = _union([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in device])
    busy_us = sum(b - a for a, b in busy)

    kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in device:
        kernels[e["name"]][0] += e["dur"] * 1e-6
        kernels[e["name"]][1] += 1

    ranges = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name", "").startswith("bench.")
              and e["name"] != "bench.trace_window"]
    runtime = [e for e in xs if e.get("cat") in RUNTIME_CATS]
    launched_by: Dict[int, Tuple[float, object]] = {}
    for e in runtime:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            launched_by[corr] = (e["ts"], e.get("tid"))
    by_corr: Dict[int, float] = defaultdict(float)
    for e in device:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            by_corr[corr] += e["dur"]
    range_stats: Dict[str, dict] = defaultdict(lambda: {"calls": 0, "device_s": 0.0})
    calls_by_tid: Dict[object, List[Tuple[float, float, str]]] = defaultdict(list)
    for r in ranges:
        range_stats[r["name"]]["calls"] += 1
        calls_by_tid[r.get("tid")].append((r["ts"], r["ts"] + r["dur"], r["name"]))
    for tid in calls_by_tid:
        calls_by_tid[tid].sort()
    for corr, us in by_corr.items():
        if corr not in launched_by:
            continue
        ts, tid = launched_by[corr]
        for name in _enclosing(calls_by_tid.get(tid, []), ts):
            range_stats[name]["device_s"] += us * 1e-6

    gaps: Dict[str, float] = defaultdict(float)
    starts, labels = _innermost_segments(ranges)
    prev = w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            i = bisect.bisect_right(starts, (prev + a) / 2) - 1
            gaps[labels[i] if i >= 0 else NO_SPAN] += (a - prev) * 1e-6
        prev = max(prev, b)
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "kernels": {k: {"device_s": v[0], "count": v[1]} for k, v in kernels.items()},
        "ranges": dict(range_stats),
        "idle_gaps": dict(gaps),
    }


def _enclosing(calls: List[Tuple[float, float, str]], ts: float) -> List[str]:
    """Names of the ranges (of one thread) that contain ``ts``."""
    i = bisect.bisect_right(calls, (ts, float("inf"), ""))
    return [name for a, b, name in calls[:i] if a <= ts <= b]


def _innermost_segments(ranges: List[dict]) -> Tuple[List[float], List[str]]:
    """The host timeline cut at every range boundary: each segment's start and
    the innermost range open over it (the one that opened last), on any thread."""
    bounds = sorted([(r["ts"], 1, i) for i, r in enumerate(ranges)] +
                    [(r["ts"] + r["dur"], 0, i) for i, r in enumerate(ranges)])
    open_ranges: Dict[int, float] = {}
    starts, labels = [], []
    for t, opening, i in bounds:
        if opening:
            open_ranges[i] = t
        else:
            open_ranges.pop(i, None)
        starts.append(t)
        labels.append(ranges[max(open_ranges, key=open_ranges.get)]["name"] if open_ranges else NO_SPAN)
    return starts, labels


def breakdown(summary: dict, top: int = 10) -> dict:
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1]["device_s"])[:top]
    gaps = sorted(summary["idle_gaps"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:200], v["device_s"]] for name, v in ops],
            "idle_gaps": [[name, s] for name, s in gaps]}


def group_device_s(summary: dict, match) -> float:
    """Device seconds of the kernels whose names ``match``."""
    return sum(v["device_s"] for name, v in summary["kernels"].items() if match(name))
