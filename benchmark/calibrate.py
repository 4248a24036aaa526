"""Readings that the correctness limits are set from, and the control's.

    python3 benchmark/calibrate.py --workload <name> --seeds <n,n,...> --control_seeds <n,n,...> --seconds 3

For each seed it runs the cell's loop for ``--seconds`` (set-up, window and
check, as ``run.py`` does) in this one process and prints the program's
compared numbers.  For each control seed it also prints the numbers of
each side that the loop's ``controls(run, config) -> {side: numbers}``
gives, read after the program's run on what it checked, and of the
program's own lower-precision path (``program_control``: the loop run
again on the same seed with the configuration's entries replaced by the
ones it names), as the program's numbers are.

The codec's loops give the control (``control``: the plain reference in the
program's place with each stage's product operands rounded one format below
what the configuration states, its ``control`` entry: fp8 for bf16, int4 for
int8; it launches no kernel) and each of the configuration's
``stage_controls`` (``control.<stage>``: only the named stages lowered), on
the checked inputs, compared with the exact reference.

Every line is JSON.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402


def new_run(args, seed, wl, config, mix):
    import torch

    from benchmark import cell
    from benchmark.run import CACHE

    return cell.Run(workload=args.workload, seed=seed, seconds=args.seconds, trace=False, wl=wl, config=config,
                    mix=mix, device=torch.device("cuda"), tmpdir=tempfile.gettempdir(),
                    aot_dir=CACHE / "benchmark", t_start=time.time())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control_seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    from benchmark.run import configure_process

    configure_process()
    import importlib

    import torch

    from benchmark import cell
    from benchmark.run import gpu_line

    cell.log(f"[gpu] {gpu_line()}; torch {torch.__version__}")
    manifest = cell.load_manifest()
    wl = cell.workload_entry(manifest, args.workload)
    config, mix = cell.config_file(manifest, wl["config"]), cell.mix_file(wl["traffic"])
    loop = importlib.import_module(f"benchmark.loops.{mix['loop']}")
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")] + sorted(control_seeds):
        run = new_run(args, seed, wl, config, mix)
        loop.run(run)
        print(json.dumps({"seed": seed, "side": "program", **run.numbers, "attempted": run.attempted,
                          "failed": run.failed, **run.end_to_end}), flush=True)
        if seed in control_seeds:
            sides = loop.controls(run, config)
            if "control" not in sides:
                print(f"benchmark/loops/{mix['loop']}.py: controls gave no control side, only {sorted(sides)}",
                      file=sys.stderr)
                return 1
            for side, numbers in sides.items():
                print(json.dumps({"seed": seed, "side": side, **numbers}), flush=True)
            del run
            torch.cuda.empty_cache()
            if "program_control" in config:
                run = new_run(args, seed, wl, dict(config, **config["program_control"]), mix)
                loop.run(run)
                print(json.dumps({"seed": seed, "side": "program_control", **config["program_control"],
                                  **run.numbers, "attempted": run.attempted, "failed": run.failed}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    sys.exit(main())
