"""The port's metric towers (UTMOS, ECAPA + WavLM features, fbank, CTC)
against the JAX package's, on the CPU at tiny widths.

Weights: one numpy-perturbed JAX tree carried into the port with
``tower_params_from_jax``.  Forwards within atol 1e-5 + rtol 1e-4; the
BiLSTM is compared on valid frames (its pad-frame outputs differ by design).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simwhisper_codec_tpu.eval import speaker as jspk
from simwhisper_codec_tpu.eval import utmos as jutmos
from simwhisper_codec_tpu.eval import wer as jwer
from simwhisper_codec_tpu.models import ssl as jssl
from simwhisper_codec_tpu_torch.eval import speaker as tspk
from simwhisper_codec_tpu_torch.eval import utmos as tutmos
from simwhisper_codec_tpu_torch.eval import wer as twer
from simwhisper_codec_tpu_torch.models import ssl as tssl
from simwhisper_codec_tpu_torch.utils import ssl_checkpoint as tckpt

from test_torch_ssl import CONFIGS, batch, perturbed
from torch_port import n, t

ATOL, RTOL = 1e-5, 1e-4
HUBERT_KW = dict(CONFIGS["fairseq"], pre_ln=True, extract_norm="layer", conv_bias=True)
UTMOS_KW = dict(num_domains=3, num_judges=300, lstm_hidden=8, emb_dim=4, proj_hidden=16)  # judge 288 exists


def close(got, want, msg=""):
    np.testing.assert_allclose(n(got), np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=msg)


def leaves_equal(got: dict, want: dict, where: str):
    a, b = dict(tssl.tree_leaves(got)), dict(tssl.tree_leaves(want))
    assert sorted(a) == sorted(b), (where, sorted(set(a) ^ set(b)))
    for k in a:
        assert torch.equal(a[k], b[k]), f"{where}: {k}"


def utmos_pair(seed=0):
    jcfg = jutmos.UTMOSConfig(ssl=jssl.SSLConfig(**CONFIGS["fairseq"]), **UTMOS_KW)
    tcfg = tutmos.UTMOSConfig(ssl=tssl.SSLConfig(**CONFIGS["fairseq"]), **UTMOS_KW)
    jtree = perturbed(jutmos.init_utmos_params(jax.random.PRNGKey(seed), jcfg), seed + 10)
    return jcfg, tcfg, jtree, tckpt.tower_params_from_jax(jtree)


def positive_variances(ecapa: dict) -> dict:
    """Perturbed batch-norm variances made positive again (in place)."""
    bns = [ecapa["layer1"]["bn"], ecapa["bn"]]
    for i in (2, 3, 4):
        bns += [ecapa[f"layer{i}"]["in"]["bn"], ecapa[f"layer{i}"]["out"]["bn"], *ecapa[f"layer{i}"]["res2"]["bns"]]
    for bn in bns:
        bn["var"] = np.abs(bn["var"]) + 0.5
    return ecapa


def speaker_pair(seed=0):
    jcfg, tcfg = jssl.SSLConfig(**CONFIGS["msft"]), tssl.SSLConfig(**CONFIGS["msft"])
    jwavlm = perturbed(jssl.init_ssl_params(jax.random.PRNGKey(seed), jcfg), seed + 20)
    jecapa = perturbed(jspk.init_ecapa(jax.random.PRNGKey(seed + 1), feat_dim=jcfg.d_model), seed + 30)
    positive_variances(jecapa)
    fw = np.linspace(-0.3, 0.4, jcfg.num_layers + 1).astype(np.float32)
    return jcfg, tcfg, jwavlm, jecapa, fw


def ctc_pair(seed=0, head_scale=1.0):
    """``head_scale`` widens the logits' spread (the transcript test: an
    argmax that no rounding can flip)."""
    jcfg, tcfg = jssl.SSLConfig(**HUBERT_KW), tssl.SSLConfig(**HUBERT_KW)
    jtree = perturbed({"ssl": jssl.init_ssl_params(jax.random.PRNGKey(seed), jcfg),
                       "lm_head": {"w": np.zeros((jcfg.d_model, 9), np.float32), "b": np.zeros(9, np.float32)}},
                      seed + 40)
    jtree["lm_head"]["w"] = jtree["lm_head"]["w"] * np.float32(head_scale)
    return jcfg, tcfg, jtree, tckpt.tower_params_from_jax(jtree)


# -- forwards -----------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["exact", "lengths"])
def test_utmos_forward_matches_jax(masked):
    jcfg, tcfg, jtree, ttree = utmos_pair()
    wav, lens = batch(seed=5, lens=(4000, 3100))
    jl, tl = (lens, t(lens, torch.int64)) if masked else (None, None)
    want = jax.jit(partial(jutmos.utmos_forward, jcfg))(jtree, wav, jl)
    with torch.no_grad():
        close(tutmos.utmos_forward(tcfg, ttree, t(wav), tl), want, "score")


def test_utmos_bilstm_head_matches_jax_on_valid_frames():
    _, _, jtree, ttree = utmos_pair(1)
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((3, 40, 32)).astype(np.float32)
    lens = np.array([40, 23, 1])
    valid = np.arange(40)[None, :] < lens[:, None]
    ids = np.zeros(3, np.int32)
    want = np.asarray(jutmos.utmos_head(jtree, feats, ids + jutmos.DOMAIN_ID, ids + jutmos.JUDGE_ID, valid))
    with torch.no_grad():
        got = n(tutmos.utmos_head(ttree, t(feats), t(lens, torch.int64)))
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL, rtol=RTOL)


def test_utmos_scorer_matches_jax():
    jcfg, tcfg, jtree, ttree = utmos_pair(2)
    wav = (np.random.default_rng(7).standard_normal(21000) * 0.1).astype(np.float32)
    want = jutmos.UTMOSScorer(params=jtree, cfg=jcfg).score(wav)
    got = tutmos.UTMOSScorer(params=ttree, cfg=tcfg, device="cpu").score(wav)
    assert abs(got - want) <= ATOL + RTOL * abs(want), (got, want)


@pytest.mark.parametrize("masked", [False, True], ids=["exact", "lengths"])
def test_wavlm_features_and_ecapa_match_jax(masked):
    jcfg, tcfg, jwavlm, jecapa, fw = speaker_pair()
    wav, lens = batch(seed=8, lens=(4000, 2600))
    jl, tl = (lens, t(lens, torch.int64)) if masked else (None, None)
    jfeats, jfl = jax.jit(partial(jspk.wavlm_weighted_features, jcfg))(jwavlm, fw, wav, jl)
    jemb = jax.jit(jspk.ecapa_forward)(jecapa, jfeats, jfl)
    with torch.no_grad():
        tfeats, tfl = tspk.wavlm_weighted_features(tcfg, tckpt.tower_params_from_jax(jwavlm), t(fw), t(wav), tl)
        close(tfeats, jfeats, "features")
        temb = tspk.ecapa_forward(tckpt.tower_params_from_jax(jecapa), tfeats, tfl)
    close(temb, jemb, "embedding")


def test_speaker_embedder_matches_jax():
    jcfg, tcfg, jwavlm, jecapa, fw = speaker_pair(3)
    wav = (np.random.default_rng(9).standard_normal(19000) * 0.1).astype(np.float32)
    want = jspk.SpeakerEmbedder(jecapa, "wavlm_large", jwavlm, fw, ssl_cfg=jcfg).embed(wav)
    got = tspk.SpeakerEmbedder(tckpt.tower_params_from_jax(jecapa), "wavlm_large",
                               tckpt.tower_params_from_jax(jwavlm), fw, ssl_cfg=tcfg, device="cpu").embed(wav)
    close(got, want)


def test_fbank_frontend_and_instance_norm_match_jax():
    wav = (np.random.default_rng(10).standard_normal((2, 8000)) * 0.1).astype(np.float32)
    with torch.no_grad():
        close(tspk.FbankFrontend(80)(t(wav)), jspk.FbankFrontend(80)(jnp.asarray(wav)), "fbank")
    x = np.random.default_rng(11).standard_normal((2, 30, 6)).astype(np.float32)
    fl = np.array([30, 17])
    close(tspk.instance_norm(t(x), frame_lengths=t(fl, torch.int64)), jspk.instance_norm(x, frame_lengths=fl))
    np.testing.assert_allclose(tspk.htk_mel_filter_bank(257, 80, 16000, 0.0, 8000.0),
                               jspk._htk_mel_filter_bank(257, 80, 16000, 0.0, 8000.0), rtol=0, atol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["exact", "lengths"])
def test_ctc_logits_match_jax(masked):
    jcfg, tcfg, jtree, ttree = ctc_pair()
    wav, lens = batch(seed=12, lens=(4000, 2900))
    jl, tl = (lens, t(lens, torch.int64)) if masked else (None, None)
    jlog, jfl = jax.jit(partial(jwer.ctc_logits, jcfg))(jtree, wav, jl)
    with torch.no_grad():
        tlog, tfl = twer.ctc_logits(tcfg, ttree, t(wav), tl)
    close(tlog, jlog, "logits")
    np.testing.assert_array_equal(n(tfl), np.asarray(jfl))


def test_ctc_transcriber_matches_jax():
    jcfg, tcfg, jtree, ttree = ctc_pair(1, head_scale=40.0)
    vocab = {0: "<pad>", 1: "<s>", 2: "</s>", 3: "<unk>", 4: "|", 5: "A", 6: "B", 7: "C", 8: "D"}
    wav = (np.random.default_rng(13).standard_normal(22000) * 0.1).astype(np.float32)
    jasr = jwer.CTCTranscriber(params=jtree, cfg=jcfg, vocab=vocab)
    tasr = twer.CTCTranscriber(params=ttree, cfg=tcfg, vocab=vocab, device="cpu")
    assert tasr.transcribe(wav) == jasr.transcribe(wav)


def test_wrappers_run_at_their_precision(monkeypatch):
    """Each wrapper runs its forward under its own ``precision`` (TF32 off by
    default; ``"default"`` turns it on, as ``eval_corpus`` times it)."""
    seen = []

    def spy(fn):
        def wrapped(*a, **k):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tutmos, "utmos_forward", spy(tutmos.utmos_forward))
    monkeypatch.setattr(tspk, "wavlm_weighted_features", spy(tspk.wavlm_weighted_features))
    monkeypatch.setattr(twer, "ctc_logits", spy(twer.ctc_logits))
    wav = (np.random.default_rng(17).standard_normal(9000) * 0.1).astype(np.float32)
    _, tcfg, _, ttree = utmos_pair(5)
    jcfg, scfg, jwavlm, jecapa, fw = speaker_pair(6)
    _, ccfg, _, ctree = ctc_pair(7)
    for precision, want in (("highest", False), ("default", True)):
        seen.clear()
        tutmos.UTMOSScorer(params=ttree, cfg=tcfg, device="cpu", precision=precision).score(wav)
        tspk.SpeakerEmbedder(tckpt.tower_params_from_jax(jecapa), "wavlm_large", tckpt.tower_params_from_jax(jwavlm),
                             fw, ssl_cfg=scfg, device="cpu", precision=precision).embed(wav)
        twer.CTCTranscriber(params=ctree, cfg=ccfg, vocab={0: "<pad>"}, device="cpu", precision=precision).logits(wav)
        assert seen == [want] * 3, (precision, seen)


def test_fbank_speaker_embedder_matches_jax():
    """The ``fbank`` frontend through ECAPA at the hop-truncated exact length."""
    jecapa = positive_variances(perturbed(jspk.init_ecapa(jax.random.PRNGKey(8), feat_dim=80), 50))
    wav = (np.random.default_rng(18).standard_normal(12345) * 0.1).astype(np.float32)
    want = jspk.SpeakerEmbedder(jecapa, "fbank").embed(wav)
    got = tspk.SpeakerEmbedder(tckpt.tower_params_from_jax(jecapa), "fbank", device="cpu").embed(wav)
    close(got, want)
