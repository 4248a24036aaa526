"""Host ms a micro-batch: the ``codec.*.host`` spans inside the window's
``serve.batch`` spans (one a kind's runner call, on the batcher thread),
summed, over the number of those batches, from the program's spans."""

from benchmark.program_spans import is_host, mean_contained_ms


def read(run):
    return mean_contained_ms(run, "serve.batch", is_host)
