"""Readings that the correctness limits are set from, and the control's.

    python3 benchmark/calibrate.py --workload <name> --seeds <n,n,...> --control_seeds <n,n,...> --seconds 3

For each seed it runs the cell's loop for ``--seconds`` (set-up, window and
check, as ``run.py`` does) in this one process and prints the program's
compared numbers.  For each control seed it also prints the numbers of

- the control: the plain reference in the program's place with each
  stage's product operands rounded one format below what the configuration
  states (its ``control`` entry: fp8 for bf16, int4 for int8), run on the
  same checked inputs (the encode inputs; its own codes decoded at the same
  chunk widths; the served decode requests' codes at their micro-batch
  widths) and compared with the exact reference; it launches no kernel;
- each of the configuration's ``stage_controls``: the same with only the
  named stages lowered;
- the program's own lower-precision path (``program_control``: the loop run
  again on the same seed with the configuration's ``mode`` replaced), as
  the program's numbers are.

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

import numpy as np  # noqa: E402


def control_offline(run, exact, formats):
    """The numbers of the reference with ``formats`` ({stage: format}) in the
    program's place, on the program's checked utterances."""
    import torch

    from benchmark.loops.offline import Checked, check
    from benchmark.reference import LowerPrecision, ReferenceCodec, float32_exact

    ctrl = ReferenceCodec(run.gp, exact.p, LowerPrecision(formats))
    overlap = run.mix["overlap_seconds"]
    with torch.no_grad(), float32_exact():
        codes = [c for c, _ in ctrl.encode([it.wav for it in run.checked], overlap)]
        outs = ctrl.decode(codes, [it.batch_frames for it in run.checked], overlap)
    items = [Checked(it.wav, c.astype(np.int32), y, it.batch_frames) for it, c, y in zip(run.checked, codes, outs)]
    return dict(check(run.gp, run.seed, run.device, items, overlap, reference=exact), low_precision_launches=0.0)


def control_serve(run, exact, formats):
    import torch

    from benchmark.loops.http_open_loop import check, checked_requests
    from benchmark.reference import LowerPrecision, ReferenceCodec, float32_exact

    res, rec = run.checked
    ctrl = ReferenceCodec(run.gp, exact.p, LowerPrecision(formats))
    enc, dec = checked_requests(run, res, rec)
    dec = [d for d in dec if d[2] is not None]
    overlap = run.mix["overlap_seconds"]
    answers = {}
    with torch.no_grad(), float32_exact():
        for (i, _), (c, _) in zip(enc, ctrl.encode([w for _, w in enc], overlap)):
            answers[f"ans_{i}"] = np.frombuffer(c.astype(np.int32).tobytes(), np.uint8)
        for (i, _, _), y in zip(dec, ctrl.decode([c for _, c, _ in dec], [w for _, _, w in dec], overlap)):
            answers[f"ans_{i}"] = np.frombuffer(y.astype(np.float32).tobytes(), np.uint8)
    return dict(check(run, res, answers, rec, reference=exact), low_precision_launches=0.0)


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
    from benchmark.reference import ReferenceCodec
    from benchmark.run import gpu_line
    from benchmark.weights import make_state

    cell.log(f"[gpu] {gpu_line()}; torch {torch.__version__}")
    manifest = cell.load_manifest()
    wl = cell.workload_entry(manifest, args.workload)
    config, mix = cell.config_file(manifest, wl["config"]), cell.mix_file(wl["traffic"])
    loop = importlib.import_module(f"benchmark.loops.{mix['loop']}")
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")] + sorted(controls):
        run = new_run(args, seed, wl, config, mix)
        loop.run(run)
        print(json.dumps({"seed": seed, "side": "program", **run.numbers, "attempted": run.attempted,
                          "failed": run.failed, **run.end_to_end}), flush=True)
        if seed in controls:
            exact = ReferenceCodec(run.gp, make_state(run.gp, seed, run.device))
            control = control_offline if mix["loop"] == "offline" else control_serve
            variants = {"control": config["control"],
                        **{f"control.{k}": v for k, v in config.get("stage_controls", {}).items()}}
            for side, formats in variants.items():
                print(json.dumps({"seed": seed, "side": side, **control(run, exact, formats)}), flush=True)
            del exact, run
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
