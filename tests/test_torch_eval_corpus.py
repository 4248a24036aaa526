"""The port's corpus report CLI (``python -m simwhisper_codec_tpu_torch.eval_corpus``)
on the CPU: a tiny codec config, a synthetic corpus, ``--full-report
--codebook_stats`` and tiny synthetic towers written by the port's tool;
its synthetic corpus and quality report against the JAX tool's; the same
run with ``--data_parallel`` over two gloo ranks against the one-process run.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import yaml

from conftest import REPO_ROOT
from simwhisper_codec_tpu_torch.eval import utmos as tutmos
from simwhisper_codec_tpu_torch.models import ssl as tssl
from simwhisper_codec_tpu_torch.tools import make_synthetic_tower_weights as tgen

from test_torch_ssl import CONFIGS
from test_torch_towers import HUBERT_KW, UTMOS_KW
from torch_port import TRAIN_THREADS

sys.path.insert(0, str(REPO_ROOT / "tools"))
import eval_corpus as jtool  # noqa: E402  (the JAX package's tool)

ENV = dict(os.environ, OMP_NUM_THREADS=str(TRAIN_THREADS))


def tiny_towers(out):
    tgen.make_hubert_ctc(out / "hubert_ctc", 0, tssl.SSLConfig(**HUBERT_KW))
    tgen.make_wavlm_ecapa(out / "wavlm.pth", 0, tssl.SSLConfig(**CONFIGS["msft"]))
    tgen.make_utmos(out / "utmos.ckpt", 0, tutmos.UTMOSConfig(ssl=tssl.SSLConfig(**CONFIGS["fairseq"]), **UTMOS_KW))
    return ["--asr_model", str(out / "hubert_ctc"), "--ecapa_checkpoint", str(out / "wavlm.pth"),
            "--utmos_checkpoint", str(out / "utmos.ckpt")]


def report_cli(tmp, ranks=1):
    """The CLI's full report on a 3-utterance synthetic corpus, tiny codec and
    towers; ``ranks`` > 1 runs it as that many gloo ranks with ``--data_parallel``.
    Returns each rank's (exit code, output)."""
    from test_codec_e2e import GENERATOR_PARAMS

    cfg = tmp / "tiny.yaml"
    cfg.write_text(yaml.safe_dump({"generator_params": GENERATOR_PARAMS}))
    cmd = [sys.executable, "-m", "simwhisper_codec_tpu_torch.eval_corpus", "--config_path", str(cfg),
           "--allow_random", "--synthetic", "3", "--output_dir", str(tmp / "out"), "--full-report",
           "--codebook_stats", "--device", "cpu", "--batch_size", "3", "--mode", "parity",
           "--report_json", str(tmp / "report.json"), *tiny_towers(tmp / "towers")]
    if ranks == 1:
        res = subprocess.run(cmd, cwd=REPO_ROOT, env=ENV, capture_output=True, text=True, timeout=600)
        return [(res.returncode, res.stdout + res.stderr)]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(cmd + ["--data_parallel"], cwd=REPO_ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=dict(ENV, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                                       LOCAL_RANK=str(r), WORLD_SIZE=str(ranks)))
             for r in range(ranks)]
    try:  # each rank has its own time limit, so a hang fails the test
        outs = [p.communicate(timeout=600)[0] for p in procs]
        return [(p.returncode, out) for p, out in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def one_process_report(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one_process")
    (rc, out), = report_cli(tmp)
    assert rc == 0, out[-3000:]
    return tmp, json.loads((tmp / "report.json").read_text())


def test_full_report_cli_on_cpu(one_process_report):
    tmp_path, report = one_process_report
    out = tmp_path / "out"
    assert report["files"] == 3 and report["skipped"] == 0 and report["mode"] == "parity"
    assert 900 < report["bitrate_bps"] < 1200 and report["codebook"]["frames"] > 0
    q = report["quality"]
    assert q["num_pairs"] == 3 and q["pesq_impl"] == "native-p862"
    for k in ("stoi", "pesq_wb", "pesq_nb", "si_snr", "snr", "lsd", "mcd"):
        assert np.isfinite(q[k]), k
    tw = report["towers"]
    assert tw["num_pairs"] == 3 and tw["wer_mode"] == "rec-vs-orig-asr (no transcripts)"
    for k in ("wer_rec", "utmos_rec", "utmos_orig", "speaker_sim"):
        assert np.isfinite(tw[k]), k
    assert all(v.startswith("ran (") for v in report["gated_metrics"].values()), report["gated_metrics"]
    timing = report["timing"]
    assert timing["codec_s"] > 0 and timing["host_metrics_s"] > 0
    assert set(timing["towers"]) == {"wer", "utmos", "speaker_sim"}
    assert all(v["audio_s"] > 0 and v["ms_per_audio_s"] > 0 and v["warmup_s"] > 0 for v in timing["towers"].values())
    # the same directories through the JAX tool's numpy report
    want = jtool.quality_report(str(out / "synthetic_corpus"), str(out / "reconstructed"))
    for k, v in want.items():
        assert q[k] == v, (k, q[k], v)


def test_full_report_data_parallel_matches_one_process(tmp_path, one_process_report):
    """Two gloo ranks split every batch: each takes the whole corpus, rank 0
    alone writes, scores and prints.  Codes are equal to the one-process
    run's (so are the bitrate and the code statistics); the waveforms differ
    by float rounding of the split batch only (within 1e-5 in
    ``test_torch_dp.py``), so the scores agree within 1e-3."""
    _, want = one_process_report
    runs = report_cli(tmp_path, ranks=2)
    for rank, (rc, out) in enumerate(runs):
        assert rc == 0, f"rank {rank}:\n{out[-3000:]}"
    assert '"quality"' in runs[0][1] and '"quality"' not in runs[1][1], "exactly one rank prints the report"
    got = json.loads((tmp_path / "report.json").read_text())
    assert sorted(p.name for p in (tmp_path / "out" / "reconstructed").iterdir()) == \
        [f"synt{i:03d}.wav" for i in range(3)]
    for k in ("files", "skipped", "bitrate_bps", "num_batches", "codebook", "mode", "weights"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert all(v.startswith("ran (") for v in got["gated_metrics"].values()), got["gated_metrics"]
    for part in ("quality", "towers"):
        assert set(got[part]) == set(want[part]), part
        for k, v in want[part].items():
            if isinstance(v, float):
                assert abs(got[part][k] - v) <= 1e-3, (part, k, got[part][k], v)
            else:
                assert got[part][k] == v, (part, k, got[part][k], v)


def test_synthetic_corpus_matches_jax(tmp_path):
    from simwhisper_codec_tpu_torch.eval_corpus import make_synthetic_corpus

    make_synthetic_corpus(tmp_path / "port", 3, seed=4, dur_range=(0.5, 1.0))
    jtool.make_synthetic_corpus(tmp_path / "jax", 3, seed=4, dur_range=(0.5, 1.0))
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) and len(names) == 3
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


def test_gated_metric_status_reads_files(tmp_path):
    from simwhisper_codec_tpu_torch.eval_corpus import gated_metric_status

    status = gated_metric_status(str(tmp_path / "none"), str(tmp_path / "none.ckpt"), None)
    assert all(v.startswith("gated: ") for v in status.values()), status
    (tmp_path / "u.ckpt").write_bytes(b"")
    assert gated_metric_status(None, str(tmp_path / "u.ckpt"), None)["utmos"].startswith("ran (")


def test_tower_metrics_with_transcripts(tmp_path):
    """With ``trans_dir`` both directories score against the ground truth,
    only over the stems it covers; here the reconstructions are the
    originals, so the two WERs are equal."""
    from simwhisper_codec_tpu_torch.eval_corpus import make_synthetic_corpus, tower_metrics

    corpus = tmp_path / "corpus"
    make_synthetic_corpus(corpus, 3, seed=5, dur_range=(0.5, 1.0))
    towers = tiny_towers(tmp_path / "towers")
    trans = tmp_path / "trans"
    trans.mkdir()
    (trans / "x.trans.txt").write_text("synt000 THE CAT SAT\nsynt002 A DOG\n")
    out = tower_metrics(str(corpus), str(corpus), asr_model=towers[1], trans_dir=str(trans), device="cpu")
    assert out["num_pairs"] == 3 and out["wer_pairs_without_transcript"] == 1
    assert out["wer_rec"] == out["wer_orig"] and out["wer_delta"] == 0.0 and "wer_mode" not in out
    assert set(out["timing"]) == {"wer"}
