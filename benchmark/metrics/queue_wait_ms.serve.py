"""The 95th percentile of the window's ``serve.queue`` spans, in ms: each request's
wait from its submit to the micro-batcher to the start of its micro-batch,
over the requests submitted in the window, from the program's spans."""

import numpy as np

from benchmark.program_spans import request_window_end_ns, window


def read(run):
    spans = window(run)
    if spans is None:
        return None
    w1 = request_window_end_ns(run)
    waits = [s.end_ns - s.start_ns for s in spans if s.name == "serve.queue" and s.start_ns <= w1 and not s.profiled]
    return float(np.percentile(waits, 95)) * 1e-6 if waits else None
