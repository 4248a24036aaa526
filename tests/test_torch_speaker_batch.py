"""``SpeakerEmbedder.embed_batch`` at a tiny size on the CPU, against the
benchmark's plain reference (``benchmark/reference_speaker.py``):

 - a tiny WavLM (2 layers, width 64, 4 heads, the published conv kernels
   and strides, the gated relative-position bias on) and a narrow ECAPA,
   drawn by ``benchmark/speaker_weights.py`` in the published state-dict
   layout and loaded through ``from_checkpoint``;
 - 10 rows over three power-of-two-second buckets, at most 4 rows a
   program, so that one bucket runs as two groups and one group is padded
   with an empty row: each row within ``TOL`` of the reference run alone at
   its exact length;
 - ``embed(w)`` is ``embed_batch([w])[0]``; fbank rows run one a program;
 - the spans tile each call and count its input;
 - the reference with the gate fixed at 1 lies far outside ``TOL``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import judge
from benchmark.reference_speaker import ReferenceSpeaker
from benchmark.speaker_weights import make_state
from simwhisper_codec_tpu_torch.eval import speaker as tspk
from simwhisper_codec_tpu_torch.models.ssl import SSLConfig, power_of_two_bucket
from simwhisper_codec_tpu_torch.utils import profiling

PUBLISHED = dict(conv_kernels=[10, 3, 3, 3, 3, 2, 2], conv_strides=[5, 2, 2, 2, 2, 2, 2])
ARCH = dict(PUBLISHED, conv_dims=[32] * 7, d_model=64, layers=2, heads=4, ffn=128, pos_conv_kernel=128,
            pos_conv_groups=16, rel_pos_buckets=320, rel_pos_max_distance=800, gate_proj=8, layer_norm_eps=1e-5,
            ecapa_channels=64, ecapa_scale=8, ecapa_layer1_kernel=5, ecapa_res2_kernel=3, ecapa_dilations=[2, 3, 4],
            ecapa_se_channels=16, ecapa_attention_channels=16, ecapa_mfa_channels=192, embedding_dim=32)
SSL = SSLConfig(d_model=64, num_layers=2, num_heads=4, ffn_dim=128, pre_ln=True, conv_dims=(32,) * 7,
                conv_bias=True, extract_norm="layer", rel_pos_bias=True)
# seconds of each row: buckets 1 s (3 rows, one below 800 samples), 2 s (5), 4 s (2)
SECONDS = (1.5, 0.03, 3.5, 1.7, 0.9, 1.9, 2.5, 1.2, 0.6, 1.3)
ROWS = 4  # rows of a full program: 1 s one group padded to 4, 2 s groups of 4 and 1, 4 s one of 2
# f32 rounding: the program's products sum in other orders than the reference's (GEMMs over
# several rows, masked keys and statistics over the bucket); read at most 2.4e-6 here
TOL = 2e-5


@pytest.fixture(scope="module")
def tower(tmp_path_factory):
    path = tmp_path_factory.mktemp("speaker") / "tiny.pth"
    state = make_state(ARCH, 2**40 + 7, "cpu")
    torch.save({"model": state, "ssl_config": dataclasses.asdict(SSL)}, path)
    rng = np.random.default_rng(5)
    wavs = [(0.1 * rng.standard_normal(int(s * 16000))).astype(np.float32) for s in SECONDS]
    return tspk.SpeakerEmbedder.from_checkpoint(str(path), device="cpu", max_rows=ROWS), state, wavs


def test_rows_match_the_reference_alone_at_their_exact_lengths(tower):
    emb, state, wavs = tower
    assert len({power_of_two_bucket(max(len(w), tspk.MIN_SAMPLES)) for w in wavs}) == 3
    got = emb.embed_batch(wavs)
    assert got.shape == (len(wavs), ARCH["embedding_dim"]) and got.dtype == np.float32
    ref = ReferenceSpeaker(state, ARCH)
    errs = [judge.wav_err(g, ref.embed(w)) for g, w in zip(got, wavs)]
    assert max(errs) <= TOL, errs


def test_groups_are_bucketed_padded_and_bounded(tower):
    emb, _, wavs = tower
    lengths = np.array([max(len(w), tspk.MIN_SAMPLES) for w in wavs])
    groups = emb._groups(lengths)
    assert [(n, r, len(rows)) for n, r, rows in groups] == [(16000, 4, 3), (32000, 4, 4), (32000, 1, 1),
                                                            (64000, 2, 2)]
    assert sorted(np.concatenate([rows for _, _, rows in groups]).tolist()) == list(range(len(wavs)))
    assert all(np.all(np.diff(lengths[rows]) >= 0) for _, _, rows in groups)
    assert [tspk.group_rows(s * 16000, 16) for s in (2, 32, 64)] == [16, 16, 8]
    assert tspk.group_rows(64 * 16000, 1) == 1
    # the card's rule: full groups, then the bucket's last rows padded to a power of two
    card = tspk.wavlm_groups(np.array([16000] + [48000] * 37 + [640000] * 5), 16)
    assert [(n, r, len(rows)) for n, r, rows in card] == [(16000, 1, 1), (64000, 16, 16), (64000, 16, 16),
                                                          (64000, 8, 5), (1024000, 8, 5)]


@pytest.mark.parametrize("seconds, rows", [(128, 2), (256, 1), (512, 1)])
def test_long_buckets_hold_the_attention_of_a_64_s_program(seconds, rows):
    # a program's (rows, heads, T, T) scores grow as rows x T^2: above 64 s no more than 8 rows at 64 s hold
    bucket = seconds * 16000
    assert tspk.group_rows(bucket, tspk.MAX_ROWS) == rows
    assert rows == 1 or rows * bucket**2 <= 8 * (64 * 16000) ** 2
    assert tspk.group_rows(bucket, 2) == 1


def test_warm_runs_every_signature_that_the_calls_meet(tower):
    emb, _, wavs = tower
    pairs = list(zip(wavs, wavs[::-1]))
    fresh = tspk.SpeakerEmbedder(emb.params, "wavlm_large", emb.wavlm_params, emb.feature_weight,
                                 ssl_cfg=emb.ssl_cfg, device="cpu", max_rows=ROWS)
    fresh.warm(tspk.pair_calls(pairs))
    count = fresh.program.count
    assert count == len({(n, r) for n, r, _ in fresh._groups(np.array([max(len(w), tspk.MIN_SAMPLES)
                                                                       for p in pairs for w in p]))})
    sims = fresh.similarities(pairs)
    assert fresh.program.count == count and sims.shape == (len(pairs),)


def test_embed_is_a_batch_of_one_row(tower):
    emb, _, wavs = tower
    for w in wavs[:3]:
        one, batch = emb.embed(w), emb.embed_batch([w])[0]
        assert judge.wav_err(one, batch) <= 1e-6
    assert emb.embed_batch([]).shape == (0, ARCH["embedding_dim"])


def test_spans_tile_each_call_and_count_its_input(tower):
    emb, _, wavs = tower
    since = profiling.clock_ns()
    emb.embed_batch(wavs)
    got = profiling.spans(since)
    (parent,) = [s for s in got if s.name == "speaker.embed"]
    inner = sorted((s for s in got if s is not parent and s.thread == parent.thread
                    and parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns), key=lambda s: s.start_ns)
    assert {s.name for s in inner} == {"speaker.embed.host", "speaker.embed.program", "speaker.embed.fetch"}
    assert {s.attrs["step"] for s in inner if s.name == "speaker.embed.host"} == {"pack", "stage", "unpack"}
    assert all(a.end_ns <= b.start_ns for a, b in zip(inner, inner[1:])), "children overlap"
    assert sum(s.end_ns - s.start_ns for s in inner) >= 0.95 * (parent.end_ns - parent.start_ns)
    assert parent.attrs == {"rows": 10, "samples": sum(len(w) for w in wavs), "groups": 4, "staging": "pageable"}
    programs = [s for s in inner if s.name == "speaker.embed.program"]
    assert [(s.attrs["rows"], s.attrs["bucket_samples"]) for s in programs] == [(4, 16000), (4, 32000), (1, 32000),
                                                                                (2, 64000)]
    assert all(s.attrs["source"] == "eager" for s in programs)
    assert sum(s.name == "speaker.embed.fetch" for s in inner) == 1


def test_the_gate_moves_every_embedding_far_beyond_the_tolerance(tower):
    _, state, wavs = tower
    ref, fixed = ReferenceSpeaker(state, ARCH), ReferenceSpeaker(state, ARCH, gate=False)
    errs = [judge.wav_err(fixed.embed(w), ref.embed(w)) for w in wavs]
    assert min(errs) > 100 * TOL, errs


def test_fbank_rows_run_one_a_program_at_their_exact_lengths():
    emb = tspk.SpeakerEmbedder(None, "fbank", seed=3, device="cpu")
    rng = np.random.default_rng(9)
    wavs = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (700, 16321, 9000)]
    got = emb.embed_batch(wavs)
    assert [(n, r) for n, r, _ in emb._groups(np.array([800, 16321, 9000]))] == [(800, 1), (16320, 1), (8960, 1)]
    for g, w in zip(got, wavs):
        n = max(len(w), 800) // 160 * 160
        x = np.zeros((1, n), np.float32)
        x[0, : min(len(w), n)] = w[:n]
        with torch.no_grad():
            want = tspk.ecapa_forward(emb.params, emb.frontend(torch.from_numpy(x)))[0].numpy()
        assert np.array_equal(g, want)
