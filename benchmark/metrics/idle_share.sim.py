"""The device's idle share of the traced sub-window: 1 - busy / window."""

from benchmark.readers import idle_percent


def read(run):
    return idle_percent(run)
