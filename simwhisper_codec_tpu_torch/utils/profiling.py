"""Tracing and per-stage timing on ``torch.profiler`` (counterpart of the JAX
package's ``utils/profiling.py``).

 - ``trace(logdir)``: context manager that profiles CPU and CUDA activity
   and writes a TensorBoard-loadable trace (``<host>.<pid>.<ms>.pt.trace.json``,
   Chrome trace format) under ``logdir``;
 - ``annotate(name)``: a named region in such a trace (``record_function``);
 - ``StageTimer``: wall-clock stage accounting that synchronises the CUDA
   device of the result it is given before it stops the clock, for
   tokenize / detokenize breakdowns.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Dict

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile CPU and (when present) CUDA activity; the trace lands under ``logdir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield
    logger.info("profiler trace written to %s", logdir)


@contextlib.contextmanager
def annotate(name: str):
    """Name a region so it shows up in profiler traces."""
    with torch.profiler.record_function(name):
        yield


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
