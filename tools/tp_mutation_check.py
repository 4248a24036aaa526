#!/usr/bin/env python3
"""Plant two tensor-parallel faults at run time and show that the TP checks
of ``chip_smoke.py`` (phase 8) fail on each.

Faults, patched into this process and into the TP ranks it starts (no
source file changes):

  b2-every-rank  the partial down pass's bias on every model rank
                 (``ops/fused_convnext.py::rank_bias`` returns b2 everywhere),
                 so the reduced sum holds it model-size times;
  local-hmax     B3's partial mode quantises h by each rank's own row max
                 (the hmax all-reduce between its up passes skipped).

First the checks run unpatched and must pass: the partial-mode kernel rows
(``tp_kernel_rows``), then the one-process references and a model group of
2 sharing the card over gloo (``tp_group``, with the dry run).  Then, for
each fault, the kernel rows and the fast round trips (fast, fast-dw,
fast-int8; the unpatched run's dry-run result stands in for the dry run,
which runs no partial pass) must fail.  Prints each check's outcome, with
its failure's message, and one JSON line of them; exits 1 if a fault went
unnoticed or the unpatched checks failed.

Run from the repository root on the machine with the GPU:
    python3 tools/tp_mutation_check.py
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

FAULTS = ("b2-every-rank", "local-hmax")
FAULT_RUNS = ("fast", "fast-dw", "fast-int8")


@contextlib.contextmanager
def planted(fault: str):
    """``fault`` patched into ``ops/fused_convnext.py`` for the block's duration."""
    from simwhisper_codec_tpu_torch.ops import fused_convnext as fc

    saved = fc.rank_bias, fc._ffn_launch
    if fault == "b2-every-rank":
        fc.rank_bias = lambda b2, first: b2
    elif fault == "local-hmax":
        launch = fc._ffn_launch

        def own_row_max(kind, *operands, reduce_max=None, **kw):
            return launch(kind, *operands, reduce_max=None if reduce_max is None else (lambda hmax: None), **kw)

        fc._ffn_launch = own_row_max
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        fc.rank_bias, fc._ffn_launch = saved


def attempt(fn) -> str:
    """'passed', or the check's failure (every broken bound of a TP group)."""
    try:
        fn()
    except AssertionError as err:
        return f"failed: {err}"
    return "passed"


def worker(args) -> None:
    """One TP rank of a faulted group: ``chip_smoke.tp_worker`` on the fast runs, the fault planted."""
    import torch

    from simwhisper_codec_tpu_torch.parallel import dryrun

    work = Path(args.work_dir)
    cs.TP_RUNS = {label: cs.TP_RUNS[label] for label in FAULT_RUNS}
    clean = json.loads((work / "dryrun_clean.json").read_text())
    dryrun.run = lambda *a, **kw: clean
    with planted(args.worker):
        cs.tp_worker(torch, work, args.tp_model_axis, args.tp_backend)


def faulted_group(torch, cfg, work: Path, fault: str, one_process_ms: dict) -> None:
    """``chip_smoke.tp_group`` with its ranks started as faulted workers of this tool."""
    start = cs.start

    def start_worker(args, log_path, env=None):
        if args and args[0] == cs.__file__:
            args = [__file__, "--worker", fault, *args[1:]]
        return start(args, log_path, env)

    cs.start = start_worker
    try:
        cs.tp_group(torch, cfg, work, 2, 2, "gloo", one_process_ms)
    finally:
        cs.start = start


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--worker", choices=FAULTS, default=None, help="run as a faulted TP rank")
    ap.add_argument("--check", default=None, help="as chip_smoke.py passes it to a TP rank")
    ap.add_argument("--work_dir", default=None)
    ap.add_argument("--tp_model_axis", type=int, default=2)
    ap.add_argument("--tp_backend", default="gloo")
    args = ap.parse_args()
    if args.worker:
        worker(args)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("tp_mutation_check: no CUDA device", file=sys.stderr)
        return 2
    from simwhisper_codec_tpu_torch.config import load_config
    from simwhisper_codec_tpu_torch.ops import _cuda

    cs.log(f"[mutation] {cs.gpu_line()}")
    cs.log(f"[mutation] {len(_cuda.SOURCES)} kernels built in {_cuda.build_kernels():.1f} s")
    cfg = load_config(cs.TP_CONFIG)
    rows = lambda: cs.tp_kernel_rows(torch)
    outcome = {"unpatched": {}}
    with torch.no_grad():
        outcome["unpatched"]["kernel_rows"] = attempt(rows)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        ms = cs.tp_references(torch, cfg, work)
        first = {}
        outcome["unpatched"]["round_trips"] = attempt(lambda: first.update(cs.tp_group(torch, cfg, work, 2, 2,
                                                                                       "gloo", ms)))
        if not first:
            print(json.dumps(outcome))
            return 1
        (work / "dryrun_clean.json").write_text(json.dumps(first["dryrun"]))
        for fault in FAULTS:
            cs.log(f"[mutation] fault {fault}")
            with torch.no_grad(), planted(fault):
                found = {"kernel_rows": attempt(rows)}
            torch.cuda.empty_cache()
            found["round_trips"] = attempt(lambda: faulted_group(torch, cfg, work, fault, ms))
            outcome[fault] = found
    for case, found in outcome.items():
        for check, result in found.items():
            cs.log(f"[mutation] {case} / {check}: {result}")
    print(json.dumps(outcome))
    clean = all(v == "passed" for v in outcome["unpatched"].values())
    caught = all(v.startswith("failed") for f in FAULTS for v in outcome[f].values())
    return 0 if clean and caught else 1


if __name__ == "__main__":
    sys.exit(main())
