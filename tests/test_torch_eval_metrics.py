"""The port's numpy evaluation copies against the JAX package's, on the CPU.

STOI, SI-SNR, SNR, LSD, MCD, native PESQ (NB and WB), the fixture codecs,
``pair_metrics`` / ``average_metrics``, ``CodebookStats`` and the WER text
pipeline (``characterize``, ``Calculator``, ``greedy_ctc_decode``) must give
the JAX package's results on the same seeded signals: equal, or within
1e-12 where a float path differs only in the module it runs from.  The
behavioural PESQ pins of ``tests/test_pesq.py`` run on the port's copy.
"""

import sys

import numpy as np
import pytest

from conftest import REPO_ROOT
from simwhisper_codec_tpu.config import QuantizerConfig as JQuantizerConfig
from simwhisper_codec_tpu.eval import codebook as jcb
from simwhisper_codec_tpu.eval import fixture_codecs as jfc
from simwhisper_codec_tpu.eval import metrics as jm
from simwhisper_codec_tpu.eval import pesq_native as jpn
from simwhisper_codec_tpu.eval import wer as jwer
from simwhisper_codec_tpu_torch.config import QuantizerConfig
from simwhisper_codec_tpu_torch.eval import codebook as tcb
from simwhisper_codec_tpu_torch.eval import evaluator as tev
from simwhisper_codec_tpu_torch.eval import fixture_codecs as tfc
from simwhisper_codec_tpu_torch.eval import metrics as tm
from simwhisper_codec_tpu_torch.eval import pesq_native as tpn
from simwhisper_codec_tpu_torch.eval import wer as twer

sys.path.insert(0, str(REPO_ROOT / "tools" / "base_eval"))
import evaluator as jev  # noqa: E402  (the reference-shaped tool of the JAX package)

TOL = 1e-12


def make_voice(seconds=3.0, sr=16000, seed=7, f_base=95.0):
    """tests/test_pesq.py's bright, gated synthetic voice."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    f0 = f_base + 25 * np.sin(2 * np.pi * 1.7 * t)
    sig = sum(np.sin(2 * np.pi * h * np.cumsum(f0) / sr + rng.uniform(0, 6)) / h ** 0.5 for h in range(1, 40))
    env = np.clip(np.sin(2 * np.pi * 2.2 * t) - 0.3, 0, None) ** 2 * 2.0
    return (sig * env * 0.08).astype(np.float64)


def noisy_pair(seed: int, snr_db: float = 20.0, seconds: float = 2.0):
    x = make_voice(seconds=seconds, seed=seed)
    n = np.random.default_rng(seed + 1000).standard_normal(len(x)) * np.std(x) * 10 ** (-snr_db / 20)
    return x.astype(np.float32), (x + n).astype(np.float32)


def same(got, want):
    if got is None or want is None:
        assert got is want is None
    else:
        assert abs(got - want) <= TOL, (got, want)


@pytest.mark.parametrize("seed", [1, 2])
def test_metric_functions_match_jax(seed):
    ref, deg = noisy_pair(seed, snr_db=10.0 + 5 * seed)
    same(tm.stoi(ref, deg, 16000), jm.stoi(ref, deg, 16000))
    same(tm.si_snr(ref, deg), jm.si_snr(ref, deg))
    same(tm.snr(ref, deg), jm.snr(ref, deg))
    same(tm.log_spectral_distance(ref, deg), jm.log_spectral_distance(ref, deg))
    same(tm.mel_cepstral_distortion(ref, deg, 16000), jm.mel_cepstral_distortion(ref, deg, 16000))
    for mode in ("wb", "nb"):
        same(tm.pesq_score(ref, deg, 16000, mode), jm.pesq_score(ref, deg, 16000, mode))
    assert tm.have_pesq() == jm.have_pesq()


def test_native_pesq_and_resampled_rates_match_jax():
    ref, deg = noisy_pair(3, snr_db=25.0)
    for fs, mode in ((16000, "wb"), (16000, "nb"), (8000, "nb")):
        same(tpn.pesq(fs, ref, deg, mode), jpn.pesq(fs, ref, deg, mode))
    same(tpn.pesq_raw(ref.astype(np.float64), deg.astype(np.float64), 16000),
         jpn.pesq_raw(ref.astype(np.float64), deg.astype(np.float64), 16000))


def test_fixture_codecs_match_jax():
    x = make_voice(seconds=1.0, sr=8000, seed=17)
    pcm = np.round(x * 32767).astype(np.int16)
    np.testing.assert_array_equal(tfc.ulaw_encode(pcm), jfc.ulaw_encode(pcm))
    np.testing.assert_array_equal(tfc.alaw_encode(pcm), jfc.alaw_encode(pcm))
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(tfc.ulaw_decode(codes), jfc.ulaw_decode(codes))
    np.testing.assert_array_equal(tfc.alaw_decode(codes), jfc.alaw_decode(codes))
    np.testing.assert_array_equal(tfc.g711_ulaw(x), jfc.g711_ulaw(x))
    np.testing.assert_array_equal(tfc.g711_alaw(x), jfc.g711_alaw(x))
    for rate in (16000, 24000, 32000, 40000):
        np.testing.assert_array_equal(tfc.g726(x, rate), jfc.g726(x, rate))
    np.testing.assert_array_equal(tfc.mnru(x, 20.0), jfc.mnru(x, 20.0))


def test_pair_and_average_metrics_match_the_jax_evaluator():
    rows_t, rows_j = [], []
    for seed in (4, 5):
        ref, deg = noisy_pair(seed, snr_db=18.0, seconds=1.5)
        deg = deg[:-321]  # unequal lengths: both length-match and clip
        rt, rj = tev.pair_metrics(ref, deg, 16000), jev.pair_metrics(ref, deg, 16000)
        assert rt.keys() == rj.keys()
        for k in rt:
            same(rt[k], rj[k])
        rows_t.append(rt)
        rows_j.append(rj)
    rows_t.append({"stoi": float("nan"), "pesq_wb": None})
    rows_j.append({"stoi": float("nan"), "pesq_wb": None})
    at, aj = tev.average_metrics(rows_t), jev.average_metrics(rows_j)
    assert at.keys() == aj.keys() and all(abs(at[k] - aj[k]) <= TOL for k in at)


def test_codebook_stats_match_jax():
    rng = np.random.default_rng(0)
    ts, js = tcb.CodebookStats(QuantizerConfig()), jcb.CodebookStats(JQuantizerConfig())
    for codes in (rng.integers(0, 2016, (8, 500)).astype(np.int32), rng.integers(0, 40, (8, 2, 77)).astype(np.int32),
                  np.zeros((8, 10), np.int32)):
        ts.update(codes)
        js.update(codes)
    np.testing.assert_array_equal(ts.counts, js.counts)
    assert ts.report() == js.report() and ts.report(25.0) == js.report(25.0)


TEXTS = ["hello, world", ",hello", "你好 <noise> ok", "abc<t>def", "<incomplete", "Hello, world! <noise> 你好",
         "the  cat\tsat\n", "ÉCOLE café's", "a<b>c <d e>f"]


def test_wer_text_pipeline_matches_jax():
    for s in TEXTS:
        assert twer.characterize(s) == jwer.characterize(s), s
        assert twer.normalize_text(s) == jwer.normalize_text(s), s
        assert twer.stripoff_tags(s) == jwer.stripoff_tags(s), s
    tc, jc = twer.Calculator(), jwer.Calculator()
    rng = np.random.default_rng(1)
    words = ["the", "cat", "sat", "on", "a", "mat", "<unk>", "dog"]
    for i in range(12):
        lab = " ".join(rng.choice(words, rng.integers(0, 8)))
        rec = " ".join(rng.choice(words, rng.integers(0, 8)))
        st, sj = tc.calculate(f"u{i}", lab, rec), jc.calculate(f"u{i}", lab, rec)
        assert (st.cor, st.sub, st.ins, st.dele) == (sj.cor, sj.sub, sj.ins, sj.dele)
    assert tc.wer == jc.wer and tc.report() == jc.report()


def test_greedy_ctc_decode_matches_jax():
    vocab = {0: "<pad>", 1: "<s>", 2: "</s>", 3: "<unk>", 4: "|", 5: "C", 6: "A", 7: "T"}
    rng = np.random.default_rng(2)
    for _ in range(20):
        ids = rng.integers(0, 9, rng.integers(0, 30))  # id 8 is not in the vocabulary
        assert twer.greedy_ctc_decode(ids, vocab) == jwer.greedy_ctc_decode(ids, vocab)


# -- tests/test_pesq.py's behavioural pins, on the port's copy ------------------


def _clean_ceiling():
    x = make_voice()
    assert tpn.pesq(16000, x, x) > 4.55
    assert tpn.pesq(16000, x, x, "nb") > 4.4


def _monotonic_in_noise():
    x = make_voice(seed=11, f_base=130.0)
    noise = np.random.default_rng(99).standard_normal(len(x))
    prev_wb, prev_nb = 5.0, 5.0
    for snr in (35, 25, 15, 5):
        n = noise * np.std(x) * 10 ** (-snr / 20)
        wb, nb = tpn.pesq(16000, x, x + n), tpn.pesq(16000, x, x + n, "nb")
        assert wb < prev_wb - 0.1 and nb < prev_nb - 0.1, (snr, wb, nb)
        prev_wb, prev_nb = wb, nb
    assert prev_wb < 2.2


def _plausible_scale():
    x = make_voice(seed=3)
    n = np.random.default_rng(123).standard_normal(len(x)) * np.std(x) * 10 ** (-25 / 20)
    assert 2.4 < tpn.pesq(16000, x, x + n) < 3.9


def _wb_penalizes_lowpass():
    x = make_voice(seed=5)
    spec = np.fft.rfft(x)
    spec[np.fft.rfftfreq(len(x), 1 / 16000) > 3500] = 0
    y = np.fft.irfft(spec, len(x))
    wb, nb = tpn.pesq(16000, x, y), tpn.pesq(16000, x, y, "nb")
    assert wb < 4.2 and nb > wb - 0.2


def _delay_compensated():
    x = make_voice(seed=13)
    delayed = np.concatenate([np.zeros(800), x])[: len(x)]
    assert tpn.pesq(16000, x, delayed) > 3.5
    assert tpn.pesq_raw(x, x, 16000) == pytest.approx(4.5, abs=1e-6)


def _pesq_score_never_none():
    x = make_voice(seconds=1.5).astype(np.float32)
    wb, nb = tm.pesq_score(x, x, 16000, "wb"), tm.pesq_score(x, x, 16000, "nb")
    assert wb is not None and wb > 4.5 and nb is not None and nb > 4.3


@pytest.mark.parametrize("check", [_clean_ceiling, _monotonic_in_noise, _plausible_scale, _wb_penalizes_lowpass,
                                   _delay_compensated, _pesq_score_never_none], ids=lambda f: f.__name__[1:])
def test_native_pesq_behaviour(check):
    check()
