"""The port's trainer CLI and its kill-and-resume soak, on the CPU at the
``--smoke`` widths (``python -m simwhisper_codec_tpu_torch.experiments.codec.train``
and ``...soak``)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO_ROOT
from torch_port import TRAIN_THREADS

ENV = dict(os.environ, OMP_NUM_THREADS=str(TRAIN_THREADS))


def test_trainer_cli_smoke_truncates_then_appends(tmp_path):
    """``--smoke --device cpu``: a fresh 3-step run truncates an old log, writes
    ckpt_0000003.pt; a resumed run to step 4 appends one row."""
    out = tmp_path / "run"
    out.mkdir()
    (out / "train_log.jsonl").write_text('{"step": 99, "g_loss": 0.0}\n')
    cmd = [sys.executable, "-m", "simwhisper_codec_tpu_torch.experiments.codec.train", "--smoke", "--device", "cpu",
           "--output_folder", str(out), "--log_every", "1"]
    res = subprocess.run(cmd + ["--steps", "3"], cwd=REPO_ROOT, env=ENV, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    rows = [json.loads(line) for line in (out / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3]
    for r in rows:
        for k in ("g_loss", "d_loss", "adv", "feat_match", "mel_l1"):
            assert np.isfinite(r[k]), (k, r)
    assert (out / "ckpt_0000003.pt").exists()
    res = subprocess.run(cmd + ["--steps", "4", "--resume", str(out / "ckpt_0000003.pt")], cwd=REPO_ROOT, env=ENV,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    rows2 = [json.loads(line) for line in (out / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows2] == [1, 2, 3, 4] and rows2[:3] == rows


@pytest.mark.slow  # three trainer runs with a real SIGKILL, minutes on the CPU
def test_soak_kill_resume_is_bit_exact(tmp_path):
    res = subprocess.run([sys.executable, "-m", "simwhisper_codec_tpu_torch.experiments.codec.soak",
                          "--output_folder", str(tmp_path / "soak"), "--steps", "12", "--timeout", "1200",
                          "--smoke", "--device", "cpu"], cwd=REPO_ROOT, env=ENV, capture_output=True, text=True,
                         timeout=3600)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-2000:])
    report = json.loads((tmp_path / "soak" / "SOAK_REPORT.json").read_text())
    assert report["equivalent"] is True and report["post_resume_points_checked"] > 0
    assert report["resume_step"] < report["steps"] and "SIGKILL" in res.stdout
