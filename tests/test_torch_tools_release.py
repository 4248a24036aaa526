"""The port's PESQ twins and release drill (``simwhisper_codec_tpu_torch/tools/``)
against the JAX package's tools, on the CPU, through ``main()`` in process:

 - ``pesq_conformance``: the same JSON over the whole suite, written to the
   twin's default under ``docs/torch/``, on the synthetic carrier and on the
   demo-page audio of a reference tree given by ``--reference_root``;
   ``pesq_calibrate``: the same JSON on a 1.5 s carrier (the full run is
   ``slow``); neither writes over the JAX package's ``docs/PESQ_*.json``;
 - ``release_check --dry_run`` at TINY with tiny towers: ready, with the
   load stage's checksum report against the JAX report of the same ``.pt``
   and the parity stage's skip equal to the JAX stage's without a reference
   checkout; exit 1 when no stage that ran was ready.
"""

import argparse
import json
import re
import sys

import numpy as np
import pytest
import yaml

from simwhisper_codec_tpu.utils import checkpoint as jckpt
from simwhisper_codec_tpu_torch.tools import pesq_calibrate, pesq_conformance, release_check
from simwhisper_codec_tpu_torch.utils.audio_io import save_audio

from test_codec_e2e import GENERATOR_PARAMS
from test_torch_tools import data, jax_tool, run_jax  # noqa: F401  (``data`` is a fixture)
from torch_port import TINY, TRAIN_THREADS, torch_threads


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Six test workers share the host's cores: two torch threads each."""
    with torch_threads():
        yield


# -- PESQ -------------------------------------------------------------------------


def test_pesq_conformance_matches_jax(tmp_path, monkeypatch, capsys):
    """The whole suite on the synthetic carrier (the JAX tool held to it
    too); the twin writes to its default, under docs/torch/ of the root it is
    given."""
    jpc = jax_tool("pesq_conformance.py")
    monkeypatch.setattr(jpc, "REF_ASSETS", tmp_path / "no_reference")
    run_jax(monkeypatch, jpc, ["--out", str(tmp_path / "j.json")])
    monkeypatch.setattr(pesq_conformance, "REPO_ROOT", tmp_path)
    pesq_conformance.main([])
    got = json.loads((tmp_path / "docs" / "torch" / "PESQ_CONFORMANCE.json").read_text())
    assert got == json.loads((tmp_path / "j.json").read_text()) and got["suite_pairs"] == 17
    assert capsys.readouterr().out.count("(17 pairs)") == 2


def test_pesq_conformance_reads_the_reference_root(tmp_path, monkeypatch, capsys):
    """A reference tree with one demo-page carrier and one codec pair:
    the twin reads it from ``--reference_root`` alone, as the JAX tool reads
    its fixed location."""
    assets = tmp_path / "reference" / "docs" / "assets" / "codec"
    assets.mkdir(parents=True)
    voice = pesq_conformance.synthetic_voice(1.5)
    save_audio(assets / "gt_sample1.wav", voice)
    save_audio(assets / "simwhisper_sample1.wav", voice + 0.01 * np.random.default_rng(3).standard_normal(len(voice)))
    jpc = jax_tool("pesq_conformance.py")
    monkeypatch.setattr(jpc, "REF_ASSETS", assets)
    run_jax(monkeypatch, jpc, ["--out", str(tmp_path / "j.json")])
    pesq_conformance.main(["--reference_root", str(tmp_path / "reference"), "--out", str(tmp_path / "t.json")])
    got = json.loads((tmp_path / "t.json").read_text())
    assert got == json.loads((tmp_path / "j.json").read_text()) and got["suite_pairs"] == 18
    assert "gt1/identity" in got["pairs"] and "codec/simwhisper_sample1" in got["pairs"]
    assert capsys.readouterr().out.count("(18 pairs)") == 2


def _calibrations_match(tmp_path, monkeypatch, argv) -> None:
    jcal = jax_tool("pesq_calibrate.py")
    monkeypatch.setattr(jcal.pc, "REF_ASSETS", tmp_path / "no_reference")
    run_jax(monkeypatch, jcal, ["--out", str(tmp_path / "j.json"), *argv])
    monkeypatch.setattr(pesq_conformance, "REPO_ROOT", tmp_path)
    pesq_calibrate.main(argv)
    got = json.loads((tmp_path / "docs" / "torch" / "PESQ_CALIBRATION.json").read_text())
    assert got == json.loads((tmp_path / "j.json").read_text()) and got["nb_anchors"]


def test_pesq_calibrate_matches_jax_on_a_short_carrier(tmp_path, monkeypatch):
    for mod in (pesq_conformance, jax_tool("pesq_calibrate.py").pc):
        monkeypatch.setattr(mod, "load_carriers",
                            lambda sr=16000, assets=None, m=mod: {"synthetic": m.synthetic_voice(1.5, sr)})
    _calibrations_match(tmp_path, monkeypatch, ["--fit-nb"])


@pytest.mark.slow  # the whole calibration twice: ~45 s
def test_pesq_calibrate_matches_jax(tmp_path, monkeypatch):
    _calibrations_match(tmp_path, monkeypatch, ["--fit-nb"])


@pytest.mark.parametrize("tool", [pesq_conformance, pesq_calibrate])
def test_pesq_twins_refuse_the_jax_records(tool, capsys):
    for record in pesq_conformance.JAX_RECORDS:
        before = record.read_bytes()
        with pytest.raises(SystemExit) as exit_:
            tool.main(["--out", str(record)])
        assert exit_.value.code == 2 and record.read_bytes() == before
    assert "JAX package's record" in capsys.readouterr().err


# -- release drill ------------------------------------------------------------------


def test_release_check_dry_run(data, monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", str(TRAIN_THREADS))  # the corpus stage's child
    cfg = data["tmp"] / "tiny.yaml"
    params = dict(GENERATOR_PARAMS, vocos=dict(GENERATOR_PARAMS["vocos"], num_layers=TINY.vocos.num_layers))
    cfg.write_text(yaml.safe_dump({"generator_params": params}))
    work = data["tmp"] / "drill"
    with pytest.raises(SystemExit) as exit_:
        release_check.main(["--dry_run", "--config", str(cfg), "--workdir", str(work), "--corpus_n", "3",
                            "--device", "cpu", "--asr_model", data["asr"], "--utmos_checkpoint", data["utmos"],
                            "--ecapa_checkpoint", data["ecapa"]])
    out = capsys.readouterr().out
    assert exit_.value.code == 0, out
    readiness = json.loads((work / "READINESS.json").read_text())
    stages = readiness["stages"]
    assert readiness["ready"] and readiness["dry_run"] and list(stages) == ["load", "parity", "bench", "corpus"]
    assert json.loads(out.splitlines()[-2]) == {"ready": True, "stages": {k: v["ok"] for k, v in stages.items()}}

    # parity: no --reference_root, so skipped as the JAX stage skips it
    # without the reference checkout
    jrc = jax_tool("release_check.py")
    monkeypatch.setattr(jrc, "REFERENCE", data["tmp"] / "no_reference")
    assert {k: v for k, v in stages["parity"].items() if k != "wall_s"} == jrc.stage_parity(None)
    assert stages["bench"]["ok"] is None and "ROADMAP A.1" in stages["bench"]["skipped"]

    # load: the checksum report against the JAX report of the same .pt (XOR
    # and element counts are independent of layout and layer stacking)
    lines = (work / "checksums.txt").read_text().splitlines()
    assert stages["load"]["ok"] and len(lines) == stages["load"]["tensors"]
    jlines = jckpt.param_checksum_report(jckpt.load_codec_params(readiness["codec_checkpoint"], TINY)).splitlines()

    def totals(report_lines):
        size, xor = 0, 0
        for line in report_lines:
            shape = json.loads(re.search(r"(\[[0-9, ]*\])\s+mean=", line)[1])
            size += int(np.prod(shape, dtype=np.int64))
            xor ^= int(line.rsplit("xor32=", 1)[1], 16)
        return size, xor

    assert totals(lines) == totals(jlines)
    assert stages["load"]["parameters"] == totals(jlines)[0]

    # corpus: every tower ran, the three files were reconstructed
    corpus = stages["corpus"]
    assert corpus["ok"] and corpus["gated_metrics"] == []
    assert {"stoi", "pesq_wb", "wer_rec", "utmos_rec", "speaker_sim", "bitrate_bps"} <= set(corpus["quality"])
    recon = sorted(p.name for p in (work / "corpus_out" / "reconstructed").iterdir())
    assert recon == ["synt000.wav", "synt001.wav", "synt002.wav"]

    # not ready (only stages that skip ran): exit 1
    with pytest.raises(SystemExit) as exit_:
        release_check.main(["--codec_checkpoint", readiness["codec_checkpoint"], "--config", str(cfg),
                            "--workdir", str(work / "none"), "--skip", "load,bench,corpus", "--device", "cpu"])
    assert exit_.value.code == 1
    assert json.loads((work / "none" / "READINESS.json").read_text())["ready"] is False


def test_release_check_reference_root_is_explicit(tmp_path, monkeypatch):
    """The parity stage's oracle comes from ``--reference_root`` alone: none
    given, or one that is not mounted, skips it; a mounted one goes on
    ``sys.path``."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    assert not release_check.add_reference_to_path(None)
    assert not release_check.add_reference_to_path(tmp_path / "absent")
    assert release_check.stage_parity(argparse.Namespace(reference_root=None)) == {
        "ok": None, "skipped": "reference repo not mounted"}
    assert release_check.add_reference_to_path(tmp_path) and str(tmp_path.resolve()) in sys.path
