"""What the readers of the program's own spans share.

The port keeps a bounded log of the spans it records inside itself
(``simwhisper_codec_tpu_torch.utils.profiling``: ``AudioCodec.encode`` /
``decode`` tiled by host, program and fetch spans; the micro-batcher's
``serve.queue`` and ``serve.batch``), on the Unix clock.  A reader takes
the spans that began in the measured window (at or after ``run.t_start +
run.setup_s``), leaves out those marked ``profiled`` (begun while the
traced sub-window's profiler ran, whose cost would inflate host times),
and gives ``None`` where the program keeps no such log or the log dropped
a record inside the window.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import List, Optional


def window(run) -> Optional[list]:
    """The window's spans, ``profiled`` ones included (``None``: no complete log)."""
    from simwhisper_codec_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    w0 = round((run.t_start + run.setup_s) * 1e9)
    kept = profiling.spans()
    # records are appended as they close: one pushed out ended before the oldest kept
    if profiling.dropped() and (not kept or kept[0].end_ns >= w0):
        return None
    return [s for s in kept if s.start_ns >= w0]


def request_window_end_ns(run) -> int:
    """Requests submitted after this were not due in the window."""
    return round((run.t_start + run.setup_s + run.seconds) * 1e9)


def is_host(name: str) -> bool:
    return name.startswith("codec.") and name.endswith(".host")


def contained_ns(spans: list, parent: str, child) -> List[int]:
    """For each ``parent`` span, the summed duration of the spans named ``child(name)``
    that lie inside it on its thread; a parent is left out where it or a span
    inside it is ``profiled``."""
    by_thread = defaultdict(list)
    for s in spans:
        by_thread[s.thread].append(s)
    sums = []
    for ss in by_thread.values():
        ss.sort(key=lambda s: s.start_ns)
        starts = [s.start_ns for s in ss]
        for p in ss:
            if p.name != parent:
                continue
            lo, hi = bisect.bisect_left(starts, p.start_ns), bisect.bisect_right(starts, p.end_ns)
            inner = [s for s in ss[lo:hi] if s is not p and s.end_ns <= p.end_ns]
            if p.profiled or any(s.profiled for s in inner):
                continue
            sums.append(sum(s.end_ns - s.start_ns for s in inner if child(s.name)))
    return sums


def mean_contained_ms(run, parent: str, child) -> Optional[float]:
    spans = window(run)
    if spans is None:
        return None
    sums = contained_ns(spans, parent, child)
    return 1e-6 * sum(sums) / len(sums) if sums else None
