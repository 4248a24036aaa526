"""What the per-layer metric readers (``metrics/<name>.py``) share."""

from __future__ import annotations

from typing import Optional

from benchmark import yardstick
from benchmark.devtrace import group_device_s


def idle_percent(run) -> Optional[float]:
    t = run.trace_summary
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def range_device_ms(run, name: str) -> Optional[float]:
    """Device ms per call of the ``bench.<name>`` range, in the traced sub-window."""
    r = (run.trace_summary or {}).get("ranges", {}).get(f"bench.{name}")
    if not r or not r["calls"] or r["device_s"] <= 0:
        return None
    return 1e3 * r["device_s"] / r["calls"]


def tokenized_audio_s(run) -> float:
    """Audio seconds handed to the tokenize programs: rows x samples of each call's input."""
    sr = run.gp["input_sample_rate"]
    return sum(c["batch"] * c["frames"] for c in run.recorder.program_calls if c["direction"] == "tokenize") / sr


def ffn_roofline_percent(run, group: str) -> Optional[float]:
    """Share of its roofline that the LN-FFN kernel ``group`` (B2 / B3) reached in
    the traced sub-window: the sum of each traced call's bound over the kernels'
    summed device time."""
    if not run.trace_summary:
        return None
    bound = 0.0
    for call in run.recorder.program_calls:
        if not call["traced"]:
            continue
        for key, n in call["launches"].items():
            parsed = yardstick.parse_ffn_key(key)
            if parsed is None or parsed[0] != group:
                continue
            _, dtype, c, inter = parsed
            m, separate = yardstick.ffn_rows(run.gp, call["direction"], call["batch"], call["frames"], c, inter)
            bound += n * yardstick.ffn_call_bound_s(dtype, m, c, inter, separate)
    seconds = group_device_s(run.trace_summary, lambda name: yardstick.in_group(name, group))
    if bound <= 0 or seconds <= 0:
        return None
    return 100.0 * bound / seconds
