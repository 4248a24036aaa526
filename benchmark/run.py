"""Run one benchmark cell of SimWhisper-Codec's PyTorch port on the GPU.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads the cell from ``BENCHMARK.json`` (its configuration, its mix and the
mix's loop driver), makes the weights and inputs from the seed, warms every
shape, measures for ``--seconds``, checks a seeded sample of what the timed
path produced against the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, ``breakdown`` (``--trace 1``) and ``checks`` (each compared
number with its limit; also the last lines of standard error).

Exits 3 without a result when CUDA is absent or has fewer devices than the
cell asks for, and 4 when the run leaves JAX or the JAX package loaded.
Kernel libraries are built into ``.aot_cache/benchmark`` and Triton's cache
into ``.aot_cache/triton`` at the checkout's root; other files go under
``$TMPDIR``.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".aot_cache"

FORBIDDEN = ("jax", "jaxlib", "flax", "simwhisper_codec_tpu")


def configure_process() -> None:
    """Caches at fixed paths inside the checkout; libraries kept from loading JAX;
    the benchmark imported as a package from the checkout."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path[:1]:
        sys.path.insert(0, str(ROOT))


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not load (compared whole)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def gpu_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def make_run(args, device, root: Path = ROOT):
    from benchmark import cell

    manifest = cell.load_manifest(root)
    wl = cell.workload_entry(manifest, args.workload)
    return manifest, cell.Run(
        workload=args.workload, seed=args.seed, seconds=args.seconds, trace=bool(args.trace), wl=wl,
        config=cell.config_file(manifest, wl["config"], root), mix=cell.mix_file(wl["traffic"]), device=device,
        tmpdir=tempfile.gettempdir(), aot_dir=CACHE / "benchmark", t_start=T_START)


def execute(manifest: dict, run) -> tuple:
    """Drive the cell's loop, then reduce what it found to the result line."""
    from benchmark import cell, judge

    importlib.import_module(f"benchmark.loops.{run.mix['loop']}").run(run)
    ok, checks = judge.verdict(run.numbers, judge.load_limits(run.workload))
    if run.trace:
        if run.trace_summary is None:
            raise RuntimeError("the traced run recorded no trace")
        metrics = {}
        for entry in cell.per_layer_entries(manifest, run.workload):
            value = cell.metric_reader(entry["name"])(run)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        values = dict(run.end_to_end, setup_s=run.setup_s)
        units = {m["name"]: m["unit"] for m in manifest["end_to_end"]}
        missing = [n for n in cell.end_to_end_names(manifest, run.workload) if n not in values]
        if missing:
            raise RuntimeError(f"the loop measured no {missing}")
        metrics = {n: {"value": values[n], "unit": units[n]} for n in cell.end_to_end_names(manifest, run.workload)}
    return {"correct": ok, "attempted": run.attempted, "failed": run.failed, "metrics": metrics}, checks


def main(argv=None) -> int:
    args = parse_args(argv)
    configure_process()
    import torch

    from benchmark.cell import log

    log(f"[gpu] {gpu_line()}; torch {torch.__version__}")
    manifest, run = make_run(args, torch.device("cuda"))
    if not torch.cuda.is_available() or torch.cuda.device_count() < run.wl["chips"]:
        log(f"run.py: the cell needs {run.wl['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 3
    result, checks = execute(manifest, run)
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": run.wl["chips"],
                        "memory_peak_bytes": run.memory_peak_bytes}
    if run.trace:
        from benchmark.devtrace import breakdown

        result["device"].update(busy_s=run.trace_summary["busy_s"], window_s=run.trace_summary["window_s"])
        result["breakdown"] = breakdown(run.trace_summary)
    result["checks"] = checks
    loaded = forbidden_modules()
    if loaded:
        log(f"run.py: the run loaded {loaded}; the benchmark measures the PyTorch port only")
        return 4
    from benchmark import judge

    for line in judge.check_lines(checks):
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # not benchmark/: its modules are imported as the package's
    sys.exit(main())
