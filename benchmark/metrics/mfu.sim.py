"""The speaker tower's share of the chip's float32 peak: the least time the
FLOPs of the window's input rows could take, each row counted at its exact
length (``speaker_yardstick``), at the H100 SXM's f32 rate outside the tensor
cores, over the window's wall time."""

from benchmark import speaker_yardstick


def read(run):
    window = run.counters.get("window_s", 0.0)
    flops = run.counters.get("input_flops", 0.0)
    if window <= 0 or flops <= 0:
        return None
    return 100.0 * flops / speaker_yardstick.F32_PEAK / window
