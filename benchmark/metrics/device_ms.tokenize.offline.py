"""Device ms per tokenize call in the traced sub-window: the kernels launched
inside the harness's ``bench.tokenize`` ranges, by the profiler's correlation."""

from benchmark.readers import range_device_ms


def read(run):
    return range_device_ms(run, "tokenize")
