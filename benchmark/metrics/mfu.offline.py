"""The whole round trip's share of the chip's peak: the least time the input
audio's ledger FLOPs could take (each component over the peak of the precision
the configuration runs it in) over the window's wall time."""

from benchmark import yardstick


def read(run):
    window = run.counters.get("window_s", 0.0)
    if window <= 0:
        return None
    least = run.counters["input_audio_s"] * yardstick.least_seconds_per_audio_second(run.gp, run.config["precision"])
    return 100.0 * least / window
