"""Training soak: a GAN run killed with SIGKILL mid-run and resumed, against a
continuous one.

Counterpart of ``experiments/codec/soak.py``:

  run A (continuous): ``train --steps N``
  run B (killed):     ``train --steps N`` beside run A, SIGKILLed once its log
                      shows step k, then resumed from its last complete
                      checkpoint to N
  check: B's losses equal A's bit for bit at every common logged step.  The
         full state (both models, both optimizers, the step), step-keyed
         crops and deterministic kernels make a resumed run reproduce the
         continuous one on the same device.

A checkpoint is written to a temporary file and renamed, so a kill during a
save leaves no ``ckpt_*.pt`` that looks complete.  The soak fails if run B
ends before the kill lands.  Writes ``SOAK_REPORT.json``.

Run:  python -m simwhisper_codec_tpu_torch.experiments.codec.soak --output_folder soak \\
          --steps 300 [train arguments, e.g. --smoke --device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
LOSS_KEYS = ("g_loss", "d_loss", "adv", "feat_match", "mel_l1")


def read_log(folder: Path) -> dict:
    """step -> logged record (later rows win: a resumed run repeats steps)."""
    rows = {}
    log = folder / "train_log.jsonl"
    if log.exists():
        for line in log.read_text().splitlines():
            if line.strip():
                rec = json.loads(line)
                rows[rec["step"]] = rec
    return rows


def start_train(args_list) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", "simwhisper_codec_tpu_torch.experiments.codec.train"]
                            + args_list, cwd=REPO_ROOT)


def wait_train(proc: subprocess.Popen, timeout_s: float, kill_at_step: int = None, log_folder: Path = None) -> int:
    """Wait for a trainer; with ``kill_at_step``, SIGKILL it once its log shows
    that step (progress-based, whatever the start-up time).  Raises if the
    run outlives ``timeout_s`` or ends before the kill."""
    deadline = time.time() + timeout_s
    try:
        while proc.poll() is None and time.time() < deadline:
            rows = read_log(log_folder) if kill_at_step is not None else {}
            if rows and max(rows) >= kill_at_step:
                print(f"soak: SIGKILL at logged step {max(rows)} >= {kill_at_step} (pid {proc.pid})", flush=True)
                os.kill(proc.pid, signal.SIGKILL)
                proc.wait()
                return -signal.SIGKILL
            time.sleep(0.1)
        if proc.poll() is None:
            raise RuntimeError(f"trainer still running after {timeout_s} s")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if kill_at_step is not None:
        raise RuntimeError(f"run B ended (rc {proc.returncode}) before its log showed step {kill_at_step}")
    return proc.returncode


_CKPT_RE = re.compile(r"^ckpt_(\d+)\.pt$")


def last_checkpoint(folder: Path):
    """The latest complete checkpoint (``*.pt.tmp`` files of a killed save never match)."""
    ckpts = sorted(p for p in folder.glob("ckpt_*.pt") if _CKPT_RE.match(p.name))
    return ckpts[-1] if ckpts else None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--output_folder", required=True)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--kill_fraction", type=float, default=0.5,
                    help="kill run B once its log reaches this fraction of the steps")
    ap.add_argument("--timeout", type=float, default=3600.0, help="seconds allowed for each trainer run")
    args, passthrough = ap.parse_known_args(argv)

    out = Path(args.output_folder).resolve()
    a_dir, b_dir = out / "runA", out / "runB"
    ckpt_every = max(1, args.steps // 6)  # several resume points before the kill
    common = ["--steps", str(args.steps), "--log_every", "1", "--checkpoint_every", str(ckpt_every),
              "--seed", "7", *passthrough]

    print("=== run A (continuous) and run B (killed mid-run), side by side ===", flush=True)
    kill_step = min(args.steps - 1, max(ckpt_every + 1, int(args.kill_fraction * args.steps)))
    t0 = time.time()
    proc_a = start_train(common + ["--output_folder", str(a_dir)])
    try:
        wait_train(start_train(common + ["--output_folder", str(b_dir)]), args.timeout, kill_at_step=kill_step,
                   log_folder=b_dir)
        rc = wait_train(proc_a, args.timeout)
    finally:
        if proc_a.poll() is None:
            proc_a.kill()
            proc_a.wait()
    if rc != 0:
        raise RuntimeError(f"run A failed: rc {rc}")
    a_wall = time.time() - t0
    log_a = read_log(a_dir)
    ckpt = last_checkpoint(b_dir)
    if ckpt is None:
        raise RuntimeError("run B died before its first checkpoint; raise --kill_fraction")
    print(f"=== resume from {ckpt} ===", flush=True)
    rc = wait_train(start_train(common + ["--output_folder", str(b_dir), "--resume", str(ckpt)]), args.timeout)
    if rc != 0:
        raise RuntimeError(f"resumed run B failed: rc {rc}")
    log_b = read_log(b_dir)
    if args.steps not in log_a or args.steps not in log_b:
        raise RuntimeError("a run did not reach its last step")

    resume_step = int(_CKPT_RE.match(ckpt.name).group(1))
    mismatches = [(s, k, log_a[s][k], log_b[s][k]) for s in sorted(log_a) if s in log_b
                  for k in LOSS_KEYS if log_a[s][k] != log_b[s][k]]
    verdict = {
        "steps": args.steps,
        "runA_wall_s": round(a_wall, 1),
        "kill_step": kill_step,
        "resume_step": resume_step,
        "post_resume_points_checked": sum(1 for s in log_a if s > resume_step and s in log_b) * len(LOSS_KEYS),
        "mismatches": mismatches[:10],
        "equivalent": not mismatches,
        "final_losses_A": {k: log_a[args.steps][k] for k in LOSS_KEYS},
    }
    (out / "SOAK_REPORT.json").write_text(json.dumps(verdict, indent=1))
    print(json.dumps(verdict, indent=1))
    if mismatches or verdict["post_resume_points_checked"] == 0:
        raise SystemExit(f"resumed run differs from the continuous one: {mismatches[:3]}")
    return verdict


if __name__ == "__main__":
    main()
