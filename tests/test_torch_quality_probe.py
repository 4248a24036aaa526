"""The port trainer's held-out quality probe (``--eval_every``) on the CPU:
its rows from the CLI at the ``--smoke`` widths, and one probe row against
the JAX trainer's ``_make_quality_eval`` on the same carried weights
(within 1e-3 per metric); a ``quality_curve`` run (``slow``).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from conftest import REPO_ROOT
from simwhisper_codec_tpu.models import codec as jcodec
from simwhisper_codec_tpu_torch.experiments.codec import train as ttrain

from torch_port import TINY, TRAIN_THREADS, informative_params, port_model, torch_threads

sys.path.insert(0, str(REPO_ROOT))
from experiments.codec import train as jtrain  # noqa: E402  (the JAX trainer)

ENV = dict(os.environ, OMP_NUM_THREADS=str(TRAIN_THREADS))
KEYS = ("stoi", "si_snr", "pesq_wb")


def test_probe_row_matches_the_jax_probe(tmp_path):
    segment_samples, mel_frames = 7680, 48  # the --smoke segment: 0.48 s
    params = informative_params(0)
    seg_mel = jtrain._seg_mel(TINY, segment_samples)
    seg_log_mel = jax.jit(lambda w: jtrain.mel_ops.log_mel(seg_mel, w))
    run = jtrain._make_quality_eval(TINY, jcodec.CodecConstants(TINY), seg_log_mel, segment_samples, mel_frames,
                                    None, tmp_path, 0)
    want = run(jax.tree.map(np.asarray, params), 0)
    probe = ttrain.QualityProbe(TINY, ttrain.segment_mel(TINY, segment_samples), segment_samples, mel_frames, None,
                                tmp_path / "port.jsonl", ttrain.torch.device("cpu"))
    np.testing.assert_array_equal(probe.batch, ttrain.eval_batch(TINY, segment_samples))
    with torch_threads():
        got = probe(port_model(params), 0)
    assert got["n_eval"] == want["n_eval"] == 8
    for k in KEYS:
        assert got[k] is not None and abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    assert json.loads((tmp_path / "port.jsonl").read_text().splitlines()[0]) == got


def test_synthetic_voice_matches_jax():
    for seed in (10_000, 10_007):
        np.testing.assert_array_equal(ttrain.synthetic_voice(seed, 0.5, 16000), jtrain.synthetic_voice(seed, 0.5, 16000))


def test_trainer_cli_writes_quality_rows(tmp_path):
    """``--smoke --eval_every 2 --steps 2``: rows for steps 0 and 2; a fresh
    run truncates an old log, a resumed run appends."""
    out = tmp_path / "run"
    out.mkdir()
    (out / "quality_log.jsonl").write_text('{"step": 99}\n')
    cmd = [sys.executable, "-m", "simwhisper_codec_tpu_torch.experiments.codec.train", "--smoke", "--device", "cpu",
           "--output_folder", str(out), "--eval_every", "2", "--checkpoint_every", "2"]
    res = subprocess.run(cmd + ["--steps", "2"], cwd=REPO_ROOT, env=ENV, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    rows = [json.loads(line) for line in (out / "quality_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 2]
    for r in rows:
        assert r["n_eval"] == 8 and all(np.isfinite(r[k]) for k in KEYS), r
    res = subprocess.run(cmd + ["--steps", "3", "--resume", str(out / "ckpt_0000002.pt")], cwd=REPO_ROOT, env=ENV,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    rows2 = [json.loads(line) for line in (out / "quality_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows2] == [0, 2, 3] and rows2[:2] == rows


@pytest.mark.slow  # a trainer run at the --small width (batch 16 x 2 s): minutes on the CPU
def test_quality_curve_writes_its_report(tmp_path):
    """``quality_curve`` builds its corpus, trains two steps and writes the
    curve report (rows 0, 1, 2; from random init ``improved`` is false, so it
    exits 1)."""
    report = tmp_path / "curve.json"
    res = subprocess.run([sys.executable, "-m", "simwhisper_codec_tpu_torch.experiments.codec.quality_curve",
                          "--output_folder", str(tmp_path / "qc"), "--steps", "2", "--eval_every", "1",
                          "--report", str(report), "--device", "cpu"], cwd=REPO_ROOT, env=ENV, capture_output=True,
                         text=True, timeout=3600)
    assert res.returncode in (0, 1), res.stderr[-3000:]
    rep = json.loads(report.read_text())
    assert [r["step"] for r in rep["curve"]] == [0, 1, 2] and rep["heldout_files"]["synthetic_voices"] == 7
    assert res.returncode == (0 if rep["improved"] else 1)
    assert set(rep["improvement"]) == set(KEYS) and all(np.isfinite(v) for v in rep["improvement"].values())
