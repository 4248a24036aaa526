"""The port's bench (``simwhisper_codec_tpu_torch/bench.py``) against the JAX
package's ``bench.py``, on the CPU at TINY (2 + 2 layers, width 64, 30 s
chunks), batch 2, 2 iterations, each kernel wrapper running its plain
version:

 - the record's keys are the keys of the JAX bench's JSON line (read from
   its source with ``ast``, never run); the headline, ``vs_baseline`` and
   MFU arithmetic; ``flops_per_audio_sec`` against the JAX ledger;
 - the bench's programs are the serving programs: ``mode_programs``'
   keyword arguments, and each section's round trip equal to
   ``AudioCodec``'s on the same input, bit for bit;
 - the pipelined accumulator after n round trips is n times one round
   trip's, with no host read inside the chain;
 - ``BENCH_INT8_BUDGET=0`` gives the JAX bench's ``fast(bf16)`` record with
   the int8 fields null; a failure in the int8 section raises and prints no
   JSON line; without CUDA and without ``--device cpu`` ``main()`` exits 3.
The full-width bench runs on the card (``chip_smoke.py``'s bench phase).
"""

import ast
import json
import math
from dataclasses import asdict
from pathlib import Path

import pytest
import torch

from simwhisper_codec_tpu.utils.flops import codec_flops as jax_codec_flops
from simwhisper_codec_tpu_torch import bench
from simwhisper_codec_tpu_torch.config import CodecConfig
from simwhisper_codec_tpu_torch.models import codec as tcodec
from simwhisper_codec_tpu_torch.ops import fused_convnext

from test_torch_aot import HostReadGuard
from torch_port import TINY, torch_threads

REPO_ROOT = Path(__file__).resolve().parent.parent
CFG = CodecConfig.from_dict(asdict(TINY))
BATCH, ITERS = 2, 2
PEAK = 1e-3  # TFLOP/s: a peak the tiny config's rate is a sizeable share of
# section -> the serving mode whose AudioCodec runs the same programs
SECTION_MODES = {"fast(bf16)": "fast", "fast-int8(mixed)": "fast-int8", "fast-int8(full)": "fast-int8-full"}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Six test workers share the host's cores: two torch threads each."""
    with torch_threads():
        yield


def jax_bench_keys() -> list:
    """The keys of the dict that the JAX ``bench.py`` prints with ``json.dumps``."""
    tree = ast.parse((REPO_ROOT / "bench.py").read_text())
    calls = [node for node in ast.walk(tree) if isinstance(node, ast.Call)
             and isinstance(node.func, ast.Attribute) and node.func.attr == "dumps"]
    assert len(calls) == 1
    return [key.value for key in calls[0].args[0].keys]


def test_record_keys_and_arithmetic(capsys):
    out = bench.run(CFG, "cpu", batch=BATCH, iters=ITERS, peak_tflops_bf16=PEAK)
    lines = capsys.readouterr().out.splitlines()
    assert list(out) == jax_bench_keys() and len(out) == 16
    rates = ("value", "bf16_x_realtime", "latency_x_realtime", "int8_x_realtime", "int8_mixed_x_realtime")
    assert all(math.isfinite(out[k]) and out[k] > 0 for k in rates), out
    assert out["headline_mode"] == "fast-int8(mixed)" and out["value"] == out["int8_mixed_x_realtime"]
    assert out["vs_baseline"] == round(out["value"] / 10, 3)
    assert (out["metric"], out["unit"], out["flops_unit"], out["device"], out["peak_tflops_bf16"]) == (
        "codec_round_trip_throughput", "x_realtime_per_chip", "GFLOP_per_audio_sec", "cpu", PEAK)
    flops = jax_codec_flops(TINY)["total"] / 30.0
    assert out["flops_per_audio_sec"] == round(flops / 1e9, 2)
    # achieved TFLOP/s and MFU from the printed bf16 rate, within its rounding (0.005)
    achieved = flops * out["bf16_x_realtime"] / 1e12
    slack = flops * 0.005 / 1e12
    assert abs(out["achieved_tflops"] - achieved) <= 0.005 + slack
    assert abs(out["mfu"] - achieved / PEAK) <= 5e-5 + slack / PEAK
    assert 0.0 <= out["int8_code_agreement_vs_bf16"] <= 1.0
    assert [line.split(":")[1].strip() for line in lines] == list(bench.SECTIONS)


def test_programs_are_the_serving_programs():
    model = tcodec.SimWhisperCodec(CFG)
    progs = bench.programs(model)
    want = {"tok": (tcodec.tokenize, tcodec.mode_programs("fast")[0]),
            "detok": (tcodec.detokenize, tcodec.mode_programs("fast")[1]),
            "detok8": (tcodec.detokenize, tcodec.mode_programs("fast-int8")[1]),
            "tok8": (tcodec.tokenize, tcodec.mode_programs("fast-int8-full")[0])}
    assert {k: (p.fn.func, p.fn.keywords) for k, p in progs.items()} == want
    assert all(p.fn.args == (model,) for p in progs.values())
    assert len({id(p._pool) for p in progs.values()}) == 1  # one graph pool


@pytest.fixture(scope="module")
def bench_model():
    model = tcodec.init_params(CFG, torch.Generator().manual_seed(0)).eval()
    tcodec.quantize_for_mode(model, "fast-int8-full")
    return model, bench.programs(model), bench.inputs(CFG, BATCH, "cpu")


@pytest.mark.parametrize("section", list(SECTION_MODES))
def test_round_trip_equals_audio_codec(bench_model, section):
    """Bit for bit against ``AudioCodec(mode)``'s ``inference_tokenize`` +
    ``inference_detokenize`` of the same batch, on the same model."""
    model, progs, (wav, lengths, frame_valid) = bench_model
    tok, detok = (progs[name] for name in bench.SECTIONS[section])
    with torch.no_grad(), tcodec.f32_precision("default"):
        t = tok(wav, lengths)
        y = detok(t["codes"], t["codes_lengths"], frame_valid)["y"]
    codec = tcodec.AudioCodec(CFG, model, batch_size=BATCH, mode=SECTION_MODES[section], device="cpu")
    want = codec.inference_tokenize(wav.numpy(), lengths.numpy())
    assert torch.equal(t["codes"], want["codes"]) and torch.equal(t["codes_lengths"], want["codes_lengths"])
    want_y = codec.inference_detokenize(want["codes"].numpy(), want["codes_lengths"].numpy())["y"]
    assert y.dtype == want_y.dtype and torch.equal(y, want_y)


def test_pipelined_accumulator_is_n_round_trips(bench_model):
    """The chain reads nothing on the host (a replay must not wait for the
    card); its accumulator equals ``ITERS`` times one round trip's."""
    _, progs, _ = bench_model
    rt = bench.round_trips(progs, bench.inputs(CFG, 1, "cpu"))["fast(bf16)"]
    zero = torch.zeros(())
    with torch.no_grad(), tcodec.f32_precision("default"):
        one = float(rt(zero)[0])
        with HostReadGuard():
            acc = bench.chain(rt, zero, ITERS)
    assert one > 0 and abs(float(acc) - ITERS * one) <= 1e-6 * ITERS * one


def _main_lines(monkeypatch, capsys, **env) -> list:
    monkeypatch.setattr(bench, "CodecConfig", lambda: CFG)
    for key, value in {"BENCH_BATCH": "1", "BENCH_ITERS": "1", **env}.items():
        monkeypatch.setenv(key, value)
    bench.main(["--device", "cpu"])
    return capsys.readouterr().out.strip().splitlines()


def test_int8_budget_zero_gives_the_bf16_record(monkeypatch, capsys):
    lines = _main_lines(monkeypatch, capsys, BENCH_INT8_BUDGET="0")
    out = json.loads(lines[-1])
    assert list(out) == jax_bench_keys()
    assert out["headline_mode"] == "fast(bf16)" and out["value"] == out["bf16_x_realtime"] > 0
    assert out["int8_x_realtime"] is out["int8_mixed_x_realtime"] is out["int8_code_agreement_vs_bf16"] is None
    assert out["peak_tflops_bf16"] == 0.0 and out["mfu"] == 0.0 and out["device"] == "cpu"
    assert "bench: int8 budget exhausted before mixed-mode capture; skipping the rest" in lines


def test_a_failure_in_the_int8_section_raises(monkeypatch, capsys):
    def planted(*args, **kwargs):
        raise RuntimeError("planted int8 kernel failure")

    monkeypatch.setattr(fused_convnext, "fused_ln_ffn_int8", planted)
    with pytest.raises(RuntimeError, match="planted int8 kernel failure"):
        _main_lines(monkeypatch, capsys)
    out = capsys.readouterr().out
    assert "fast(bf16)" in out and not any(line.startswith("{") for line in out.splitlines())


@pytest.mark.parametrize("argv", [[], ["--device", "cuda:0"]])
def test_without_cuda_main_exits_3(monkeypatch, capsys, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_:
        bench.main(argv)
    out = capsys.readouterr().out
    assert exit_.value.code == 3 and len(out.splitlines()) == 1 and "--device cpu" in out
    assert not out.startswith("{")


@pytest.mark.parametrize("value,want", [(None, "fused"), ("", "fused"), ("1", "fused"), ("dw", "fused-dw")])
def test_fused_vocos_knob(monkeypatch, value, want):
    """``SIMWHISPER_FUSED_VOCOS``: unset (or empty) and ``1`` keep the fused
    chain, ``dw`` runs B4; ``dw`` also builds B4's library."""
    if value is None:
        monkeypatch.delenv("SIMWHISPER_FUSED_VOCOS", raising=False)
    else:
        monkeypatch.setenv("SIMWHISPER_FUSED_VOCOS", value)
    assert bench.fused_vocos_impl() == want
    assert ("convnext_dw" in bench.kernel_sources(want)) == (want == "fused-dw")
    assert set(bench.KERNEL_SOURCES) <= set(bench.kernel_sources(want))


@pytest.mark.parametrize("value", ["0", "true", "DW", "fused-dw"])
def test_fused_vocos_knob_refuses_other_values(monkeypatch, capsys, value):
    """Any other value raises before anything runs (the JAX bench would take
    any non-empty string as on)."""
    monkeypatch.setenv("SIMWHISPER_FUSED_VOCOS", value)
    monkeypatch.setattr(bench, "run", lambda *a, **k: pytest.fail("the bench ran"))
    with pytest.raises(ValueError, match=repr(value)):
        bench.main(["--device", "cpu"])
    assert capsys.readouterr().out == ""


def test_dw_knob_reaches_the_bf16_detokenize(monkeypatch, bench_model):
    """With ``dw`` the bench passes ``fused-dw`` to its ``detok`` program only
    (``mode_programs("fast", vocos_impl="fused-dw")``'s keywords); the int8
    programs keep the int8 Vocos; the round trip equals ``AudioCodec(mode="fast",
    vocos_impl="fused-dw")``'s bit for bit, and its codes are the fused bench's."""
    seen = {}
    monkeypatch.setenv("SIMWHISPER_FUSED_VOCOS", "dw")
    monkeypatch.setattr(bench, "CodecConfig", lambda: CFG)
    monkeypatch.setattr(bench, "run", lambda cfg, device, **kw: seen.update(kw) or {})
    bench.main(["--device", "cpu"])
    assert seen["vocos_impl"] == "fused-dw"
    model, progs, (wav, lengths, frame_valid) = bench_model
    dw = bench.programs(model, "fused-dw")
    assert dw["detok"].fn.keywords == tcodec.mode_programs("fast", vocos_impl="fused-dw")[1]
    assert dw["detok"].fn.keywords["vocos_impl"] == "fused-dw"
    for name in ("tok", "detok8", "tok8"):
        assert dw[name].fn.keywords == progs[name].fn.keywords
    assert dw["detok8"].fn.keywords["vocos_impl"] == "int8"
    with torch.no_grad(), tcodec.f32_precision("default"):
        t = dw["tok"](wav, lengths)
        y = dw["detok"](t["codes"], t["codes_lengths"], frame_valid)["y"]
        fused_codes = progs["tok"](wav, lengths)["codes"]
    assert torch.equal(t["codes"], fused_codes)
    codec = tcodec.AudioCodec(CFG, model, batch_size=BATCH, mode="fast", vocos_impl="fused-dw", device="cpu")
    want = codec.inference_tokenize(wav.numpy(), lengths.numpy())
    assert torch.equal(want["codes"], t["codes"])
    want_y = codec.inference_detokenize(want["codes"].numpy(), want["codes_lengths"].numpy())["y"]
    assert torch.equal(y, want_y)
