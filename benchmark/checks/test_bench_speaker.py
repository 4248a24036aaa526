"""The speaker cell's pieces on the CPU: the yardstick's count against a hand
count, the plain reference against the program at narrow widths, the loop
end to end at narrow widths (its controls too), and the four per-layer
readers on span logs made by hand (``None`` where the log dropped a record
inside the window)."""

import dataclasses
import math
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import cell, judge, speaker_yardstick
from benchmark.loops import speaker_offline
from benchmark.reference_speaker import ReferenceSpeaker, relative_position_buckets
from benchmark.speaker_weights import make_state, param_specs
from conftest import ROOT

WORKLOAD = "speaker-f32.sim-pairs"
# the published tower at narrow widths: two layers of width 64, the published conv kernels and strides,
# buckets and gate; a narrow ECAPA
TINY = dict(conv_dims=[32] * 7, conv_kernels=[10, 3, 3, 3, 3, 2, 2], conv_strides=[5, 2, 2, 2, 2, 2, 2],
            d_model=64, layers=2, heads=4, ffn=128, pos_conv_kernel=128, pos_conv_groups=16, rel_pos_buckets=320,
            rel_pos_max_distance=800, gate_proj=8, layer_norm_eps=1e-5, ecapa_channels=64, ecapa_scale=8,
            ecapa_layer1_kernel=5, ecapa_res2_kernel=3, ecapa_dilations=[2, 3, 4], ecapa_se_channels=16,
            ecapa_attention_channels=16, ecapa_mfa_channels=192, embedding_dim=32)


def published():
    return cell.config_file(cell.load_manifest(ROOT), "wavlm-large-ecapa-f32", ROOT)


def tiny_ssl_config():
    from simwhisper_codec_tpu_torch.models.ssl import SSLConfig

    return SSLConfig(d_model=64, num_layers=2, num_heads=4, ffn_dim=128, pre_ln=True, conv_dims=(32,) * 7,
                     conv_bias=True, extract_norm="layer", rel_pos_bias=True)


def tiny_embedder(state, device="cpu", precision="highest", max_rows=3):
    from simwhisper_codec_tpu_torch.eval.speaker import SpeakerEmbedder

    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/tiny.pth"
        torch.save({"model": state, "ssl_config": dataclasses.asdict(tiny_ssl_config())}, path)
        return SpeakerEmbedder.from_checkpoint(path, device=device, precision=precision, max_rows=max_rows)


# -- the yardstick -------------------------------------------------------------

def test_published_count_by_hand():
    a = published()["wavlm_ecapa"]
    # 10 s: conv frames 31999, 15999, 7999, 3999, 1999, 999, 499
    t = 499
    want = {
        "conv_stack": 2 * 512 * 10 * 31999 + 2 * 512 * 512 * 3 * (15999 + 7999 + 3999 + 1999)
        + 2 * 512 * 512 * 2 * (999 + 499),
        "projection": 2 * t * 512 * 1024,
        "positional_conv": 2 * t * 1024 * 64 * 128,
        "linears": 24 * t * (8 * 1024 ** 2 + 4 * 1024 * 4096 + 16 * 2 * 64 * 8),
        "attention": 24 * 4 * t * t * 1024,
        "weighted_sum": 2 * 25 * t * 1024,
        "ecapa": 2 * 1024 * 512 * 5 * t + 3 * ((2 * 2 * 512 * 512 + 7 * 2 * 64 * 64 * 3) * t + 2 * 2 * 512 * 128)
        + 2 * 1536 * 1536 * t + 2 * 2 * 1536 * 128 * t + 2 * 3072 * 256,
    }
    assert speaker_yardstick.utterance_flops(a, 160000) == want
    per_s = (sum(want.values()) - want["attention"]) / 10
    assert 36.5e9 < per_s < 37.0e9  # about 37 GFLOP an audio second before attention
    assert speaker_yardstick.F32_PEAK == pytest.approx(66.9e12, rel=1e-3)
    assert speaker_yardstick.utterance_flops(a, 100) == speaker_yardstick.utterance_flops(a, 800)


def test_tiny_count_by_hand():
    # 1 s: conv frames 3199, 1599, 799, 399, 199, 99, 49
    t = 49
    want = {
        "conv_stack": 2 * 32 * 10 * 3199 + 2 * 32 * 32 * 3 * (1599 + 799 + 399 + 199) + 2 * 32 * 32 * 2 * (99 + 49),
        "projection": 2 * t * 32 * 64, "positional_conv": 2 * t * 64 * 4 * 128,
        "linears": 2 * t * (8 * 64 * 64 + 4 * 64 * 128 + 2 * 64 * 8), "attention": 2 * 4 * t * t * 64,
        "weighted_sum": 2 * 3 * t * 64,
        "ecapa": 2 * 64 * 64 * 5 * t + 3 * ((2 * 2 * 64 * 64 + 7 * 2 * 8 * 8 * 3) * t + 2 * 2 * 64 * 16)
        + 2 * 192 * 192 * t + 2 * 2 * 192 * 16 * t + 2 * 384 * 32,
    }
    assert speaker_yardstick.utterance_flops(TINY, 16000) == want


def test_parameters_are_the_published_layout():
    cfg = published()
    specs = param_specs(cfg["wavlm_ecapa"])
    assert len({k for k, _, _, _ in specs}) == len(specs)
    wavlm = sum(math.prod(s) for k, s, _, _ in specs if k.startswith("feature_extract.model."))
    assert wavlm == 315455552 + 128  # the port's tree, weight_g and weight_v unfolded
    assert cfg["parameters"] - wavlm - 25 == 8426816


# -- the reference against the program -----------------------------------------------

def test_buckets_are_t5_log_buckets():
    b = relative_position_buckets(1200, 320, 800, "cpu")
    assert b[0, 0] == 0 and b[0, 5] == 165 and b[5, 0] == 5 and b[0, 79] == 239 and b[0, 1199] == 319
    assert b[1199, 0] == 159 and int(b.max()) == 319


def test_reference_matches_the_program_at_narrow_widths():
    state = make_state(TINY, 2**40 + 21, "cpu")
    rng = np.random.default_rng(4)
    wavs = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (20800, 30000, 47000, 70000, 9000)]
    got = tiny_embedder(state).embed_batch(wavs)
    ref = ReferenceSpeaker(state, TINY)
    errs = [judge.wav_err(g, ref.embed(w)) for g, w in zip(got, wavs)]
    assert max(errs) < 2e-5, errs
    fixed = ReferenceSpeaker(state, TINY, gate=False)
    assert min(judge.wav_err(fixed.embed(w), ref.embed(w)) for w in wavs) > 1e-3
    with pytest.raises(ValueError):
        ReferenceSpeaker(state, TINY, formats={"transformer": "bf16"})


# -- the loop at narrow widths ---------------------------------------------------------

def tiny_run(seconds=2.0):
    manifest = cell.load_manifest(ROOT)
    wl = cell.workload_entry(manifest, WORKLOAD)
    config = dict(cell.config_file(manifest, wl["config"], ROOT), wavlm_ecapa=TINY)
    mix = dict(cell.mix_file(wl["traffic"]), pairs_per_call=4, check_rows=4,
               length={"kind": "lognormal", "median_s": 3.0, "sigma": 0.7, "min_s": 1.3, "max_s": 9.0})
    return cell.Run(workload=WORKLOAD, seed=2**31 + 2201, seconds=seconds, trace=False, wl=wl, config=config,
                    mix=mix, device=torch.device("cpu"), tmpdir=tempfile.gettempdir(), aot_dir=ROOT / ".aot_cache",
                    t_start=time.time())


def test_the_loop_runs_checks_and_reads_its_metrics(monkeypatch):
    monkeypatch.setattr(speaker_offline, "build_embedder", lambda run, state: tiny_embedder(state))
    run = tiny_run()
    speaker_offline.run(run)
    assert run.attempted > 0 and run.attempted % 8 == 0 and run.failed == 0
    assert run.numbers["shape_errors"] == 0.0 and 0.0 < run.numbers["emb_err"] < 2e-5, run.numbers
    assert len(run.checked) >= 4 and run.end_to_end["audio_x_realtime"] > 0
    ok, _ = judge.verdict(run.numbers, judge.load_limits(WORKLOAD))
    assert ok
    for name in ("host_ms.embed.sim", "computed_per_input.sim", "mfu.sim"):
        value = cell.metric_reader(name)(run)
        assert value is not None and math.isfinite(value) and value > 0, (name, value)
    assert cell.metric_reader("computed_per_input.sim")(run) > 1.0  # buckets and empty rows
    assert cell.metric_reader("idle_share.sim")(run) is None  # no trace
    sides = speaker_offline.controls(run, run.config)
    assert set(sides) == {"control", "control.nogate"}
    # TF32 changes nothing on the CPU; the gate fixed at 1 is far outside
    assert sides["control.nogate"]["emb_err"] > 100 * run.numbers["emb_err"], sides


def test_warm_rows_cover_every_bucket_of_the_mix():
    mix = cell.mix_file("sim-pairs")
    rows = speaker_offline.warm_rows(mix, np.zeros(120 * 16000, np.float32))
    assert [len(r) for r in rows] == [32000, 64000, 128000, 256000, 512000, 560000]
    with pytest.raises(ValueError):
        speaker_offline.embedder_precision({"transformer": "f32", "ecapa": "tf32"})
    assert speaker_offline.embedder_precision(published()["program_control"]["precision"]) == "default"


def test_pairs_share_their_slice_and_cosines_pair_them():
    mix = dict(cell.mix_file("sim-pairs"), pool_seconds=40, pairs_per_call=8,
               length={"kind": "lognormal", "median_s": 2.0, "sigma": 0.5, "min_s": 1.3, "max_s": 5.0})
    pool_pair = speaker_offline.pools(mix, 2**40 + 1)
    rows, order = speaker_offline.call_rows(mix, 2**40 + 1, 3, pool_pair)
    assert len(rows) == 16 and sorted(order.tolist()) == list(range(16))
    where = np.argsort(order)
    for p in range(8):
        a, b = rows[where[2 * p]], rows[where[2 * p + 1]]
        assert len(a) == len(b) and 0.03 < float(np.std(b - a)) < 0.07
    emb = np.random.default_rng(0).standard_normal((8, 4))
    cos = speaker_offline.pair_cosines(emb[[order[i] // 2 for i in range(16)]], order)
    assert np.allclose(cos, 1.0)


def test_every_seed_runs_the_same_programs_call_by_call():
    from simwhisper_codec_tpu_torch.eval.speaker import wavlm_groups

    dist = cell.mix_file("sim-pairs")["length"]
    seeds = (2**40 + 1, 3 * 2**31 + 17)
    calls = {s: [speaker_offline.call_lengths(dist, 64, s, k) for k in range(23)] for s in seeds}
    programs = {s: [sorted((n, r) for n, r, _ in wavlm_groups(np.tile(lens, 2), 16)) for lens in calls[s]]
                for s in seeds}
    assert programs[seeds[0]] == programs[seeds[1]]
    assert not any(np.array_equal(np.sort(a), np.sort(b)) for a, b in zip(*calls.values()))
    for lens in calls.values():
        assert [k for k, row in enumerate(lens) if row.max() > 32 * 16000] == [2, 10, 18]
        everything = np.concatenate(lens) / 16000
        assert 1.3 <= everything.min() and everything.max() <= 35.0 and 7.0 < everything.mean() < 7.7


# -- the readers on span logs made by hand -----------------------------------------------

def fake_run(counters=None, summary=None):
    return SimpleNamespace(t_start=100.0, setup_s=5.0, seconds=10.0, counters=counters or {}, trace_summary=summary)


def log_with(monkeypatch, records, maxlen=64):
    from simwhisper_codec_tpu_torch.utils import profiling

    log = profiling.SpanLog(maxlen)
    monkeypatch.setattr(profiling, "_log", log)
    for r in records:
        log.append(r)
    return log


def call(t0, rows, samples, programs, host_ms=(1.0, 2.0, 3.0)):
    """One ``speaker.embed`` call at ``t0`` s: host spans of ``host_ms``, one program span each of ``programs``."""
    s = 10**9
    out = [("speaker.embed.host", 1, t0 * s, t0 * s + int(ms * 1e6), {"step": "pack"}, False) for ms in host_ms]
    out += [("speaker.embed.program", 1, t0 * s + 1000, t0 * s + 2000, {"rows": r, "bucket_samples": n,
                                                                        "source": "replayed"}, False)
            for r, n in programs]
    attrs = {"rows": rows, "samples": samples, "groups": len(programs), "staging": "pinned"}
    out.append(("speaker.embed", 1, t0 * s, t0 * s + s // 10, attrs, False))
    return out


def test_span_readers(monkeypatch):
    records = (call(101, 2, 999, [(16, 32000)])  # before the window (105 s): not read
               + call(106, 4, 50000, [(16, 32000), (8, 1024000)]) + call(107, 2, 30000, [(16, 64000)], (4.0,)))
    log_with(monkeypatch, records)
    run = fake_run()
    assert cell.metric_reader("host_ms.embed.sim")(run) == pytest.approx((6.0 + 4.0) / 2)
    want = (16 * 32000 + 8 * 1024000 + 16 * 64000) / 80000
    assert cell.metric_reader("computed_per_input.sim")(run) == pytest.approx(want)


def test_span_readers_read_nothing_where_the_log_dropped_inside_the_window(monkeypatch):
    records = call(106, 4, 50000, [(16, 32000)]) + call(107, 2, 30000, [(16, 64000)])
    log = log_with(monkeypatch, records, maxlen=len(records) - 1)
    assert log.dropped == 1
    for name in ("host_ms.embed.sim", "computed_per_input.sim"):
        assert cell.metric_reader(name)(fake_run()) is None


def test_span_readers_read_nothing_without_speaker_spans(monkeypatch):
    log_with(monkeypatch, [("codec.encode", 1, 106 * 10**9, 107 * 10**9, {"rows": 1}, False)])
    for name in ("host_ms.embed.sim", "computed_per_input.sim"):
        assert cell.metric_reader(name)(fake_run()) is None


def test_trace_and_counter_readers():
    assert cell.metric_reader("idle_share.sim")(fake_run(summary={"window_s": 4.0, "busy_s": 3.0})) == 25.0
    assert cell.metric_reader("idle_share.sim")(fake_run()) is None
    run = fake_run(counters={"input_flops": 66.9e12, "window_s": 4.0})
    assert cell.metric_reader("mfu.sim")(run) == pytest.approx(100 * 66.9e12 / speaker_yardstick.F32_PEAK / 4.0)
    assert cell.metric_reader("mfu.sim")(fake_run()) is None
