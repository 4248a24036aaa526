"""A run of one cell: the manifest entry, its configuration and mix files, and what the run found.

Everything belonging to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:
``configs/<config>.json`` (through the manifest's ``file``),
``mixes/<traffic>.json`` (whose ``loop`` names a module of ``loops/``),
``metrics/<metric>.py`` and ``limits/<workload>.json``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def synchronize(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    if device.type != "cuda":
        return 0
    import torch

    return int(torch.cuda.max_memory_allocated(device))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload_entry(manifest: dict, name: str) -> dict:
    for wl in manifest["workloads"]:
        if wl["name"] == name:
            return wl
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix_file(name: str) -> dict:
    return load_json(HERE / "mixes" / f"{name}.json")


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def end_to_end_names(manifest: dict, workload: str) -> List[str]:
    return [m["name"] for m in manifest["end_to_end"] if applies(m, workload)]


def per_layer_entries(manifest: dict, workload: str) -> List[dict]:
    reported = set(end_to_end_names(manifest, workload))
    return [m for m in manifest["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(run) -> value or None``."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Run:
    workload: str
    seed: int
    seconds: float
    trace: bool
    wl: dict
    config: dict
    mix: dict
    device: Any
    tmpdir: str
    aot_dir: Path
    t_start: float  # wall clock at process start
    # filled by the loop
    end_to_end: Dict[str, float] = dataclasses.field(default_factory=dict)
    setup_s: Optional[float] = None
    attempted: int = 0
    failed: int = 0
    numbers: Dict[str, float] = dataclasses.field(default_factory=dict)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace_summary: Optional[dict] = None
    memory_peak_bytes: int = 0
    recorder: Any = None  # spans.Recorder of the window
    checked: Any = None  # what the loop's correctness check read, for the control (calibrate.py)

    @property
    def gp(self) -> dict:
        return self.config["generator_params"]

    def elapsed_since_start(self) -> float:
        return time.time() - self.t_start
