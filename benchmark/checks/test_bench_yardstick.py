"""The roofline and MFU arithmetic on known shapes, and the trace reduction."""

import json

import pytest

from benchmark import devtrace, yardstick
from conftest import ROOT


def published_gp():
    with open(ROOT / "benchmark" / "configs" / "simwhisper-codec-int8.json") as f:
        return json.load(f)


def test_ledger_sums_to_the_programs_ledger():
    from simwhisper_codec_tpu_torch.config import CodecConfig
    from simwhisper_codec_tpu_torch.utils.flops import codec_flops

    cfg = published_gp()
    ours = yardstick.ledger(cfg["generator_params"])
    theirs = codec_flops(CodecConfig.from_dict(cfg["generator_params"]))
    assert sum(ours.values()) == theirs["total"]
    assert ours["decoder_attention"] + ours["decoder_ffn"] == theirs["decoder_transformer"]
    assert ours["vocos_depthwise"] + ours["vocos_pointwise"] == theirs["vocos_convnext"]
    assert set(cfg["precision"]) == set(ours)
    assert sum(ours.values()) / 30 == pytest.approx(43.9e9, rel=2e-3)


def test_least_time_per_audio_second_by_precision():
    cfg = published_gp()
    gp = cfg["generator_params"]
    led = yardstick.ledger(gp)
    all_bf16 = yardstick.least_seconds_per_audio_second(gp, {k: "bf16" for k in led})
    assert all_bf16 == pytest.approx(sum(led.values()) / 989.4e12 / 30)
    mixed = yardstick.least_seconds_per_audio_second(gp, cfg["precision"])
    int8 = led["decoder_ffn"] + led["vocos_pointwise"]
    tf32 = led["mel_dft"] + led["mel_filterbank"] + led["istft"]
    rest = sum(led.values()) - int8 - tf32
    assert mixed == pytest.approx((int8 / 1979e12 + tf32 / 494.7e12 + rest / 989.4e12) / 30)


def test_ffn_bounds_on_known_shapes():
    # B3 at the Vocos shape, 8 x 3000 rows: 4 m c i int8 ops over 1979 TOP/s (chip_smoke's 0.1017 ms)
    assert yardstick.ffn_call_bound_s("int8", 24000, 512, 4096, True) == pytest.approx(4 * 24000 * 512 * 4096 / 1979e12)
    assert yardstick.ffn_call_bound_s("int8", 24000, 512, 4096, True) * 1e3 == pytest.approx(0.1017, abs=1e-4)
    # B2 at the transformer shape, 8 x 1500 rows, and at the Vocos shape (chip_smoke: 0.1145 and 0.2036 ms
    # over 989 TFLOP/s; here over utils/flops.py's 989.4)
    assert yardstick.ffn_call_bound_s("bf16", 12000, 768, 3072, False) == pytest.approx(4 * 12000 * 768 * 3072 / 989.4e12)
    assert yardstick.ffn_call_bound_s("bf16", 24000, 512, 4096, True) * 1e3 == pytest.approx(0.2036, abs=2e-4)
    # a thin call is bound by its bytes
    tiny = yardstick.ffn_call_bound_s("bf16", 16, 512, 4096, True)
    assert tiny == pytest.approx((3 * 16 * 512 * 2 + 2 * 512 * 4096 * 2 + (2 * 512 + 4096) * 2) / 3.35e12)


def test_ffn_rows_from_a_program_call():
    gp = published_gp()["generator_params"]
    assert yardstick.ffn_rows(gp, "tokenize", 16, 480000, 768, 3072) == (24000, False)
    assert yardstick.ffn_rows(gp, "detokenize", 16, 375, 768, 3072) == (24000, False)
    assert yardstick.ffn_rows(gp, "detokenize", 16, 375, 512, 4096) == (48000, True)
    with pytest.raises(KeyError):
        yardstick.ffn_rows(gp, "tokenize", 16, 480000, 512, 4096)
    assert yardstick.parse_ffn_key("ln_ffn_int8:512x4096") == ("B3", "int8", 512, 4096)
    assert yardstick.parse_ffn_key("pflash_attention") is None


class FakeRun:
    def __init__(self, summary, calls, gp, config=None, counters=None):
        from benchmark.spans import Recorder

        self.trace_summary, self.gp, self.config, self.counters = summary, gp, config, counters or {}
        self.recorder = Recorder()
        self.recorder.program_calls = calls


def load_reader(name):
    from benchmark.cell import metric_reader

    return metric_reader(name)


def test_roofline_reader_is_bound_over_kernel_time():
    gp = published_gp()["generator_params"]
    calls = [{"direction": "detokenize", "batch": 16, "frames": 375, "traced": True,
              "launches": {"ln_ffn_int8:512x4096": 24, "ln_ffn_int8:768x3072": 12, "pflash_attention": 12}},
             {"direction": "detokenize", "batch": 16, "frames": 375, "traced": False,
              "launches": {"ln_ffn_int8:512x4096": 24}}]
    names = {"void (anonymous namespace)::ln_ffn_int8_upq_kernel<128>(x)": 0.010,
             "void (anonymous namespace)::ln_ffn_int8_down_kernel<256>(x)": 0.006,
             "void (anonymous namespace)::ln_ffn_bf16_up_kernel<128>(x)": 0.5}
    summary = {"kernels": {k: {"device_s": v, "count": 1} for k, v in names.items()}}
    bound = (24 * yardstick.ffn_call_bound_s("int8", 48000, 512, 4096, True)
             + 12 * yardstick.ffn_call_bound_s("int8", 24000, 768, 3072, False))
    assert load_reader("B3_roofline.offline")(FakeRun(summary, calls, gp)) == pytest.approx(100 * bound / 0.016)
    assert load_reader("B2_roofline.offline")(FakeRun(summary, calls, gp)) is None  # no B2 call traced
    assert load_reader("B3_roofline.offline")(FakeRun(None, calls, gp)) is None


def test_mfu_reader():
    cfg = published_gp()
    run = FakeRun(None, [], cfg["generator_params"], cfg, {"input_audio_s": 6400.0, "window_s": 4.0})
    least = yardstick.least_seconds_per_audio_second(cfg["generator_params"], cfg["precision"])
    assert load_reader("mfu.offline")(run) == pytest.approx(100 * 6400.0 * least / 4.0)


def trace_events():
    """Host: a window [0, 100] us, tokenize range [10, 20] launching a graph (corr 1);
    device: its two kernels [30, 40] and [45, 60], a copy [70, 75]."""
    ann = lambda name, ts, dur, tid=1: {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}
    return [ann("bench.trace_window", 0, 100), ann("bench.encode", 5, 80), ann("bench.tokenize", 10, 10),
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 12, "dur": 2, "tid": 1,
             "args": {"correlation": 1}},
            {"ph": "X", "cat": "kernel", "name": "k1", "ts": 30, "dur": 10, "args": {"correlation": 1}},
            {"ph": "X", "cat": "kernel", "name": "k2", "ts": 45, "dur": 15, "args": {"correlation": 1}},
            {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 70, "dur": 5, "args": {"correlation": 9}}]


def test_trace_summary():
    s = devtrace.summarise(trace_events())
    assert s["window_s"] == pytest.approx(100e-6) and s["busy_s"] == pytest.approx(30e-6)
    assert s["ranges"]["bench.tokenize"] == {"calls": 1, "device_s": pytest.approx(25e-6)}
    assert s["ranges"]["bench.encode"]["device_s"] == pytest.approx(25e-6)
    # idle [0, 30] (midpoint in tokenize), [40, 45] and [60, 70] (in encode), [75, 100] (after encode)
    assert s["idle_gaps"] == {"bench.tokenize": pytest.approx(30e-6), "bench.encode": pytest.approx(15e-6),
                              devtrace.NO_SPAN: pytest.approx(25e-6)}
    bd = devtrace.breakdown(s)
    assert bd["device_ops"][0] == ["k2", pytest.approx(15e-6)] and len(bd["idle_gaps"]) <= 10
