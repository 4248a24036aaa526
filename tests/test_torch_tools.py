"""The port's CLI twins (``simwhisper_codec_tpu_torch/tools/``) against the
JAX package's tools under ``tools/``, on the CPU: each ``main()`` runs in
process with its arguments (``sys.argv`` patched for the JAX tools) on the
same tiny inputs and the same tiny synthetic towers, written by the port's
tool (the JAX loaders read them at the tiny configs patched in).

 - ``evaluate_model``: the same JSON, host numpy on both sides;
 - ``calculate_wer``: the same report lines and gate; ``spk_sim_cal`` (files
   and cached ``.npy`` embeddings) and ``extract_spk_emb``: embeddings within
   the tower tests' 1e-4 and the same printed SIM; ``calculate_utmos``: each
   score within 1e-4, the same gate (exit 2); a file that cannot be decoded
   is skipped, an error of the scorer propagates;
 - ``python -m simwhisper_codec_tpu_torch.tools.<twin> --help`` for all nine.

The PESQ twins and ``release_check`` are held against theirs in
test_torch_tools_release.py.
"""

import importlib.util
import json
import re
import runpy
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest

from conftest import REPO_ROOT
from simwhisper_codec_tpu.eval import speaker as jspk
from simwhisper_codec_tpu.eval import utmos as jutmos
from simwhisper_codec_tpu.models import ssl as jssl
from simwhisper_codec_tpu_torch.eval import utmos as tutmos
from simwhisper_codec_tpu_torch.eval_corpus import make_synthetic_corpus
from simwhisper_codec_tpu_torch.models import ssl as tssl
from simwhisper_codec_tpu_torch.tools import make_synthetic_tower_weights as tgen
from simwhisper_codec_tpu_torch.tools.base_eval import evaluate_model
from simwhisper_codec_tpu_torch.tools.speaker import extract_spk_emb, spk_sim_cal
from simwhisper_codec_tpu_torch.tools.utmos import calculate_utmos
from simwhisper_codec_tpu_torch.tools.wer import calculate_wer
from simwhisper_codec_tpu_torch.utils.audio_io import load_audio, save_audio

from test_torch_ssl import CONFIGS
from test_torch_towers import HUBERT_KW, UTMOS_KW
from torch_port import torch_threads

TOWER_TOL = 1e-4  # max |d| <= TOL * max(max |ref|, 1), as in the tower tests


def jax_tool(rel: str):
    """Import one of the JAX package's tools from its file, with its own
    directory importable (the tools import their siblings by name)."""
    path = REPO_ROOT / "tools" / rel
    for d in (path.parent, REPO_ROOT / "tools"):
        if str(d) not in sys.path:
            sys.path.insert(0, str(d))
    spec = importlib.util.spec_from_file_location("jax_tool_" + rel.replace("/", "_")[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(monkeypatch, mod, argv):
    monkeypatch.setattr(sys, "argv", ["tool", *argv])
    mod.main()


def tower_close(got, want) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= TOWER_TOL * max(float(np.max(np.abs(want))), 1.0)


def printed(out: str, pattern: str) -> float:
    m = re.search(pattern, out)
    assert m, out
    return float(m[1])


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Six test workers share the host's cores: two torch threads each."""
    with torch_threads():
        yield


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Originals (3 synthetic FLAC utterances with transcripts), their noisy
    'reconstructions' (WAV, same stems) and the tiny towers."""
    tmp = tmp_path_factory.mktemp("tools")
    orig, synth = tmp / "orig", tmp / "synth"
    make_synthetic_corpus(orig, 3, seed=3, dur_range=(1.0, 2.0))
    synth.mkdir()
    rng = np.random.default_rng(4)
    for p in sorted(orig.glob("*.flac")):
        wav = load_audio(p, 16000)
        save_audio(synth / f"{p.stem}.wav", wav + 0.01 * rng.standard_normal(len(wav)).astype(np.float32))
    (orig / "synt.trans.txt").write_text("synt000 THE CAT SAT\nsynt001 A DOG RAN FAR\nsynt002 HELLO\n")
    towers = tmp / "towers"
    tgen.make_hubert_ctc(towers / "hubert_ctc", 0, tssl.SSLConfig(**HUBERT_KW))
    tgen.make_wavlm_ecapa(towers / "wavlm.pth", 0, tssl.SSLConfig(**CONFIGS["msft"]))
    tgen.make_utmos(towers / "utmos.ckpt", 0,
                    tutmos.UTMOSConfig(ssl=tssl.SSLConfig(**CONFIGS["fairseq"]), **UTMOS_KW))
    return {"tmp": tmp, "orig": str(orig), "synth": str(synth), "asr": str(towers / "hubert_ctc"),
            "ecapa": str(towers / "wavlm.pth"), "utmos": str(towers / "utmos.ckpt")}


@pytest.fixture
def jax_tiny_towers(monkeypatch):
    """The JAX loaders at the tiny tower configs (they assume the published widths)."""
    monkeypatch.setattr(jspk, "wavlm_large_config", lambda: jssl.SSLConfig(**CONFIGS["msft"]))
    monkeypatch.setattr(jutmos, "UTMOSScorer", partial(
        jutmos.UTMOSScorer, cfg=jutmos.UTMOSConfig(ssl=jssl.SSLConfig(**CONFIGS["fairseq"]), **UTMOS_KW)))


def test_evaluate_model_matches_jax(data, monkeypatch, capsys):
    out = data["tmp"] / "eval"
    out.mkdir(exist_ok=True)
    run_jax(monkeypatch, jax_tool("base_eval/evaluate_model.py"),
            ["--original_dir", data["orig"], "--synthesized_dir", data["synth"], "--output_json", str(out / "j.json")])
    evaluate_model.main(["--original_dir", data["orig"], "--synthesized_dir", data["synth"],
                         "--output_json", str(out / "t.json")])
    want, got = (json.loads((out / f"{k}.json").read_text()) for k in "jt")
    assert got.keys() == want.keys() and got["num_pairs"] == 3
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=1e-9, err_msg=k)
        else:
            assert got[k] == v, k
    assert capsys.readouterr().out.count('"stoi"') == 2


def test_calculate_wer_matches_jax(data, monkeypatch, capsys):
    argv = ["--original_dir", data["orig"], "--synthesized_dir", data["synth"], "--model", data["asr"]]
    run_jax(monkeypatch, jax_tool("wer/calculate_wer.py"), argv)
    want = capsys.readouterr().out
    calculate_wer.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert "reconstructed: utterances=3 WER=" in got and "delta WER: " in got
    assert got == want


def test_calculate_wer_gate(data, monkeypatch, capsys):
    argv = ["--original_dir", data["orig"], "--synthesized_dir", data["synth"],
            "--model", str(data["tmp"] / "no_model")]
    with pytest.raises(SystemExit) as jexit:
        run_jax(monkeypatch, jax_tool("wer/calculate_wer.py"), argv)
    want = capsys.readouterr().out
    with pytest.raises(SystemExit) as texit:
        calculate_wer.main(argv)
    got = capsys.readouterr().out
    assert jexit.value.code == texit.value.code == 2
    assert got.replace("simwhisper_codec_tpu_torch.", "simwhisper_codec_tpu.") == want


def test_spk_sim_cal_matches_jax(data, monkeypatch, capsys, jax_tiny_towers):
    argv = ["--original_dir", data["orig"], "--synthesized_dir", data["synth"], "--ecapa_checkpoint", data["ecapa"]]
    run_jax(monkeypatch, jax_tool("speaker/spk_sim_cal.py"), argv)
    want = printed(capsys.readouterr().out, r"SIM mean over 3 pairs: (\S+)")
    spk_sim_cal.main(argv + ["--device", "cpu"])
    got = printed(capsys.readouterr().out, r"SIM mean over 3 pairs: (\S+)")
    assert abs(got - want) <= 1e-4 + 1e-12  # at most one step of the printed precision


def test_extract_spk_emb_then_npy_mode_matches_jax(data, monkeypatch, capsys, jax_tiny_towers):
    jtool = jax_tool("speaker/extract_spk_emb.py")
    emb = data["tmp"] / "emb"
    for side in ("orig", "synth"):
        run_jax(monkeypatch, jtool, ["--input_dir", data[side], "--emb_dir", str(emb / f"j_{side}"),
                                     "--ecapa_checkpoint", data["ecapa"]])
        extract_spk_emb.main(["--input_dir", data[side], "--emb_dir", str(emb / f"t_{side}"),
                              "--ecapa_checkpoint", data["ecapa"], "--device", "cpu"])
        names = sorted(p.name for p in (emb / f"t_{side}").iterdir())
        assert names == sorted(p.name for p in (emb / f"j_{side}").iterdir()) and len(names) == 3
        for name in names:
            tower_close(np.load(emb / f"t_{side}" / name), np.load(emb / f"j_{side}" / name))
    assert capsys.readouterr().out.count("embedded 3 new utterances") == 4
    sims = {}
    for k in "jt":
        argv = ["--original_dir", data["orig"], "--synthesized_dir", data["synth"],
                "--orig_emb_dir", str(emb / f"{k}_orig"), "--synth_emb_dir", str(emb / f"{k}_synth")]
        (run_jax(monkeypatch, jax_tool("speaker/spk_sim_cal.py"), argv) if k == "j" else spk_sim_cal.main(argv))
        sims[k] = printed(capsys.readouterr().out, r"SIM mean over 3 pairs: (\S+)")
    assert abs(sims["t"] - sims["j"]) <= 1e-4 + 1e-12
    # a second run finds every embedding cached
    extract_spk_emb.main(["--input_dir", data["orig"], "--emb_dir", str(emb / "t_orig"),
                          "--ecapa_checkpoint", data["ecapa"], "--device", "cpu"])
    assert "embedded 0 new utterances" in capsys.readouterr().out


def test_calculate_utmos_matches_jax(data, monkeypatch, capsys, jax_tiny_towers):
    scores = {"j": [], "t": []}

    def record(side, score):
        def wrapped(self, *args, **kwargs):
            scores[side].append(score(self, *args, **kwargs))
            return scores[side][-1]
        return wrapped

    monkeypatch.setattr(jutmos.UTMOSScorer.func, "score", record("j", jutmos.UTMOSScorer.func.score))
    monkeypatch.setattr(tutmos.UTMOSScorer, "score", record("t", tutmos.UTMOSScorer.score))
    run_jax(monkeypatch, jax_tool("utmos/calculate_utmos.py"), ["--input_dir", data["synth"], "--ckpt", data["utmos"]])
    want = printed(capsys.readouterr().out, r"UTMOS mean over 3 files: (\S+)")
    calculate_utmos.main(["--input_dir", data["synth"], "--ckpt", data["utmos"], "--device", "cpu"])
    out = capsys.readouterr().out
    got = printed(out, r"UTMOS mean over 3 files: (\S+)")
    assert len(scores["t"]) == len(scores["j"]) == 3
    tower_close(scores["t"], scores["j"])
    assert f"UTMOS mean over 3 files: {np.mean(scores['t']):.3f}" in out
    assert abs(got - want) <= 1e-3 + 1e-12  # at most one step of the printed precision


def test_calculate_utmos_gate(data, monkeypatch, capsys):
    argv = ["--input_dir", data["synth"], "--ckpt", str(data["tmp"] / "none.ckpt")]
    with pytest.raises(SystemExit) as jexit:
        run_jax(monkeypatch, jax_tool("utmos/calculate_utmos.py"), argv)
    with pytest.raises(SystemExit) as texit:
        calculate_utmos.main(argv)
    assert jexit.value.code == texit.value.code == 2
    assert capsys.readouterr().out.count("UTMOS checkpoint not found") == 2


def test_decode_errors_skip_and_scorer_errors_propagate(data, monkeypatch, capsys):
    bad = data["tmp"] / "with_bad"
    bad.mkdir()
    (bad / "a.flac").write_bytes(b"fLaC" + bytes(12))
    save_audio(bad / "b.wav", load_audio(sorted(Path(data["synth"]).iterdir())[0]))
    calculate_utmos.main(["--input_dir", str(bad), "--ckpt", data["utmos"], "--device", "cpu"])
    extract_spk_emb.main(["--input_dir", str(bad), "--emb_dir", str(data["tmp"] / "bad_emb"),
                          "--ecapa_checkpoint", data["ecapa"], "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count(f"skipping {bad / 'a.flac'}") == 2
    assert "UTMOS mean over 1 files" in out and "embedded 1 new utterances" in out

    def fail(*args, **kwargs):
        raise RuntimeError("the scorer failed on the device")

    monkeypatch.setattr(tutmos.UTMOSScorer, "score", fail)
    with pytest.raises(RuntimeError, match="scorer failed"):
        calculate_utmos.main(["--input_dir", str(bad), "--ckpt", data["utmos"], "--device", "cpu"])
    monkeypatch.setattr("simwhisper_codec_tpu_torch.eval.speaker.SpeakerEmbedder.embed_batch", fail)
    with pytest.raises(RuntimeError, match="scorer failed"):
        extract_spk_emb.main(["--input_dir", str(bad), "--emb_dir", str(data["tmp"] / "bad_emb2"),
                              "--ecapa_checkpoint", data["ecapa"], "--device", "cpu"])


def test_fbank_speaker_variant_runs_without_a_checkpoint(data, capsys):
    spk_sim_cal.main(["--original_dir", data["orig"], "--synthesized_dir", data["synth"], "--device", "cpu"])
    assert np.isfinite(printed(capsys.readouterr().out, r"SIM mean over 3 pairs: (\S+)"))


TWINS = ["base_eval.evaluate_model", "wer.calculate_wer", "speaker.spk_sim_cal", "speaker.extract_spk_emb",
         "utmos.calculate_utmos", "utmos.utmos_model", "pesq_conformance", "pesq_calibrate", "release_check"]


@pytest.mark.parametrize("twin", TWINS)
def test_twin_help(twin, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [twin, "--help"])
    with pytest.raises(SystemExit) as exit_:
        runpy.run_module(f"simwhisper_codec_tpu_torch.tools.{twin}", run_name="__main__")
    assert exit_.value.code == 0 and "usage:" in capsys.readouterr().out
