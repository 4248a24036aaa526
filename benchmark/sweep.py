"""Find the highest request rate the server sustains: one server, a few fixed rates in turn.

    python3 benchmark/sweep.py --workload codec-int8.serve-short --seed <n> --seconds 15 --rates 40,60,80

For each rate it runs the cell's open-loop mix at that rate for ``--seconds``
against one running server (``loops/http_open_loop.Server``) and prints a
line: offered and served rate, p50 / p95 latency, refusals (503) and other
failures, and the median latency of the window's first and last thirds
(a backlog that grows shows as a rising last third).  A rate is sustained
when the served rate is at least 0.98 of the offered, nothing is refused,
and the last third's median is within 1.5x the first third's.  Run it on
the GPU; the mix file's ``rate_per_s`` is then set by hand to 0.8 of the
highest sustained rate.
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


def sweep_line(rate: float, seconds: float, res: dict) -> dict:
    from benchmark.loops.http_open_loop import percentile

    status = np.asarray(res["status"])
    due = np.asarray(res["due"])
    lat = np.asarray(res["latency"], dtype=np.float64)
    ok = status == 200
    done = (due + np.where(ok, lat, 0.0))[ok]
    span = max(seconds, float(done.max()) if ok.any() else seconds)
    thirds = [ok & (due >= seconds * i / 3) & (due < seconds * (i + 1) / 3) for i in (0, 2)]
    first, last = (percentile(lat[m] * 1e3, 50) for m in thirds)
    line = {"offered_per_s": len(status) / seconds, "served_per_s": int(ok.sum()) / span,
            "p50_ms": percentile(lat[ok] * 1e3, 50), "p95_ms": percentile(lat[ok] * 1e3, 95),
            "refused": int((status == 503).sum()), "failed_other": int((~ok & (status != 503)).sum()),
            "first_third_p50_ms": first, "last_third_p50_ms": last}
    line["sustained"] = (line["served_per_s"] >= 0.98 * line["offered_per_s"] and line["refused"] == 0
                         and line["failed_other"] == 0 and last <= 1.5 * first)
    return {"rate": rate, **line}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--rates", required=True, help="comma-separated requests per second")
    args = ap.parse_args(argv)
    from benchmark.run import configure_process

    configure_process()
    import torch

    from benchmark import cell
    from benchmark.loops.http_open_loop import LoadGenerator, Server, warm_requests
    from benchmark.run import CACHE, gpu_line
    from benchmark.spans import Recorder

    if not torch.cuda.is_available():
        cell.log("sweep.py: no CUDA device")
        return 3
    cell.log(f"[gpu] {gpu_line()}; torch {torch.__version__}")
    manifest = cell.load_manifest()
    wl = cell.workload_entry(manifest, args.workload)
    run = cell.Run(workload=args.workload, seed=args.seed, seconds=args.seconds, trace=False, wl=wl,
                   config=cell.config_file(manifest, wl["config"]), mix=cell.mix_file(wl["traffic"]),
                   device=torch.device("cuda"), tmpdir=tempfile.gettempdir(), aot_dir=CACHE / "benchmark",
                   t_start=T_START)
    server = Server(run, Recorder())
    try:
        server.start()
        server.wait_ready()
        warm_requests(run, server.port)
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            load = LoadGenerator(run, server.port, args.seconds, dict(run.mix, rate_per_s=rate), tag=f"sweep{i}")
            try:
                load.ready()
                load.go(time.time() + 0.05)
                res, _ = load.results()
            finally:
                load.kill()
            print(json.dumps(sweep_line(rate, args.seconds, res)), flush=True)
            time.sleep(2.0)  # let the queue drain
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    sys.exit(main())
