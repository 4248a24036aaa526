"""The evaluation towers and the recipe's feature extractors as compiled
programs (``utils/aot.py``), on the CPU at tiny widths:

 - each wrapper's program (CTC logits, UTMOS, the speaker embedding through
   WavLM and through fbank, the encoder's hidden states, the HuBERT
   features) gives what the eager function it wraps gives on the same
   padded input: bit for bit, but UTMOS, whose masked BiLSTM is held to the
   packed ``nn.LSTM`` that ran before it within 1e-6;
 - one program per bucket (per hop-truncated length for fbank; one 30 s
   window for the hidden states): a second utterance in a bucket adds no
   signature, another bucket adds one, as the JAX package's jits trace;
 - nothing inside a program reads the card on the host or makes a tensor
   from host data once its signature has been warmed up (a CUDA graph
   capture, which follows the warm-up call, would refuse it);
 - the masked BiLSTM against the JAX ``bilstm(valid=...)`` with lengths
   mixed within a batch (valid frames, atol 1e-5 + rtol 1e-4, the tower
   tests' bound), and against ``nn.LSTM`` over a packed sequence (every
   frame, pads zero in both, within 1e-6).
The capture itself runs on the card only (``chip_smoke.py`` phases 4 and 6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from simwhisper_codec_tpu.eval import utmos as jutmos
from simwhisper_codec_tpu.models import ssl as jssl
from simwhisper_codec_tpu.models import transformer as jt
from simwhisper_codec_tpu.config import EncoderConfig as JEncoderConfig
from simwhisper_codec_tpu_torch.config import EncoderConfig
from simwhisper_codec_tpu_torch.eval import speaker as tspk
from simwhisper_codec_tpu_torch.eval import utmos as tutmos
from simwhisper_codec_tpu_torch.eval import wer as twer
from simwhisper_codec_tpu_torch.experiments.hifigan_continue import extract_features as text
from simwhisper_codec_tpu_torch.models import ssl as tssl
from simwhisper_codec_tpu_torch.models.transformer import Encoder
from simwhisper_codec_tpu_torch.ops.mel import log_mel, mel_lengths
from simwhisper_codec_tpu_torch.utils import ssl_checkpoint as tckpt
from simwhisper_codec_tpu_torch.utils.checkpoint import encoder_state_from_jax

from test_torch_aot import HostReadGuard
from test_torch_hifigan_continue import ENC_KW, SSL_KW
from test_torch_towers import ATOL, RTOL, ctc_pair, speaker_pair, utmos_pair
from torch_port import n, t, torch_threads

SR = 16000
# seconds of each call: two in the 2 s bucket, then one in the 1 s bucket
SECONDS = (1.3, 1.8, 0.7)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Six test workers share the host's cores: two torch threads each (the
    CPU LSTM slows by two orders of magnitude when they oversubscribe them)."""
    with torch_threads():
        yield


def padded(wav: np.ndarray, length: int) -> torch.Tensor:
    out = np.zeros((1, length), np.float32)
    out[0, : len(wav)] = wav
    return torch.from_numpy(out)


class PackedBiLSTM:
    """The scorer's BiLSTM before it became a program: a bidirectional
    ``nn.LSTM`` over a packed sequence (a host read of the lengths)."""

    def __init__(self, p: dict):
        self.lstm = nn.LSTM(p["fwd"]["w_ih"].shape[1], p["fwd"]["w_hh"].shape[1], batch_first=True,
                            bidirectional=True)
        sd = {f"{'weight' if k[0] == 'w' else 'bias'}_{k[2:]}_l0{suffix}": d[k]
              for suffix, d in (("", p["fwd"]), ("_reverse", p["bwd"])) for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
        self.lstm.load_state_dict(sd)

    def __call__(self, x, lengths=None):
        if lengths is None:
            return self.lstm(x)[0]
        packed = nn.utils.rnn.pack_padded_sequence(x, lengths.cpu(), batch_first=True, enforce_sorted=False)
        return nn.utils.rnn.pad_packed_sequence(self.lstm(packed)[0], batch_first=True, total_length=x.shape[1])[0]


def _ctc():
    _, cfg, _, tree = ctc_pair(2)
    asr = twer.CTCTranscriber(params=tree, cfg=cfg, vocab={0: "<pad>"}, device="cpu")

    def eager(wav):
        norm = (wav - wav.mean()) / np.sqrt(wav.var() + 1e-7)
        m = max(len(wav), 800)
        logits, fl = twer.ctc_logits(cfg, tree, padded(norm, tssl.power_of_two_bucket(m)), torch.tensor([m]))
        return logits[0, : int(fl[0])]

    return asr.program, asr.logits, eager, 0.0


def _utmos():
    _, cfg, _, tree = utmos_pair(3)
    scorer = tutmos.UTMOSScorer(params=tree, cfg=cfg, device="cpu")
    packed = PackedBiLSTM(tree["lstm"])

    def eager(wav):
        x = padded(wav, tssl.power_of_two_bucket(len(wav)))
        return tutmos.utmos_forward(cfg, tree, x, torch.tensor([max(len(wav), 400)]), packed)[0]

    return scorer.program, scorer.score, eager, 1e-6


def _speaker_wavlm():
    _, cfg, jwavlm, jecapa, fw = speaker_pair(4)
    ecapa, wavlm = tckpt.tower_params_from_jax(jecapa), tckpt.tower_params_from_jax(jwavlm)
    emb = tspk.SpeakerEmbedder(ecapa, "wavlm_large", wavlm, fw, ssl_cfg=cfg, device="cpu")

    def eager(wav):
        m = max(len(wav), 800)
        feats, fl = tspk.wavlm_weighted_features(cfg, wavlm, t(fw), padded(wav, tssl.power_of_two_bucket(m)),
                                                 torch.tensor([m]))
        return tspk.ecapa_forward(ecapa, feats, fl)[0]

    return emb.program, emb.embed, eager, 0.0


def _speaker_fbank():
    emb = tspk.SpeakerEmbedder(None, "fbank", seed=5, device="cpu")
    ecapa = emb.params

    def eager(wav):
        m = max(len(wav), 800) // tspk.FbankFrontend.HOP * tspk.FbankFrontend.HOP
        return tspk.ecapa_forward(ecapa, tspk.FbankFrontend(80)(padded(wav, m)))[0]

    return emb.program, emb.embed, eager, 0.0


def _hidden_states():
    tree = jax.tree.map(np.asarray, jt.init_encoder(jax.random.PRNGKey(3), JEncoderConfig(**ENC_KW)))
    encoder = Encoder(EncoderConfig(**ENC_KW))
    encoder.load_state_dict(encoder_state_from_jax(tree))
    ext = text.FeatureExtractor(EncoderConfig(**ENC_KW), encoder, 1, device="cpu")

    def eager(wav):
        feats = log_mel(ext.mel_consts, padded(wav, ext.fe_cfg.n_samples))
        lens = mel_lengths(torch.tensor([len(wav)]), ext.fe_cfg.hop_length, ext.mel_consts.n_frames)
        _, out_len, states = encoder(feats, lens, output_hidden_states=True)
        return states[1][0, : int(out_len[0])]

    return ext.program, ext.extract, eager, 0.0


def _hubert():
    tree = jax.tree.map(np.asarray, jssl.init_ssl_params(jax.random.PRNGKey(5), jssl.SSLConfig(**SSL_KW)))
    params = tckpt.ssl_params_from_jax(tree)
    cfg = tssl.SSLConfig(**SSL_KW)
    ext = text.HubertFeatureExtractor(ssl_cfg=cfg, params=params, layer_id=1, device="cpu")

    def eager(wav):
        out = tssl.ssl_forward(cfg, params, padded(wav, tssl.power_of_two_bucket(len(wav))),
                               torch.tensor([len(wav)]))
        return out["hidden_states"][1][0, : int(out["frame_lengths"][0])]

    return ext.program, ext.extract, eager, 0.0


TOWERS = {"ctc": _ctc, "utmos": _utmos, "speaker-wavlm": _speaker_wavlm, "speaker-fbank": _speaker_fbank,
          "hidden-states": _hidden_states, "hubert": _hubert}
# signatures after each call of SECONDS: a bucket each (fbank: a length each; hidden states: one 30 s window)
COUNTS = {"speaker-fbank": [1, 2, 3], "hidden-states": [1, 1, 1]}


@pytest.mark.parametrize("tower", list(TOWERS))
def test_program_equals_the_eager_call_one_signature_per_bucket(tower):
    program, call, eager, tol = TOWERS[tower]()
    rng = np.random.default_rng(21)
    counts = []
    for seconds in SECONDS:
        wav = (rng.standard_normal(int(seconds * SR)) * 0.1).astype(np.float32)
        got = call(wav)
        with torch.no_grad():
            want = n(eager(wav))
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)  # UTMOS: a float
        assert got.shape == want.shape and got.dtype == np.float32, (got.shape, want.shape)
        assert np.max(np.abs(got - want)) <= tol, (tower, seconds, float(np.max(np.abs(got - want))))
        counts.append(program.count)
    assert counts == COUNTS.get(tower, [1, 1, 2]), counts
    assert program.source == "eager"  # the CPU runs a program's function


@pytest.mark.parametrize("tower", list(TOWERS))
def test_programs_read_nothing_on_the_host(tower):
    """The second call of a signature, as a capture follows the warm-up call
    (which may fill a cache, e.g. WavLM's relative-position buckets)."""
    program, call, _, _ = TOWERS[tower]()
    wav = (np.random.default_rng(22).standard_normal(int(1.5 * SR)) * 0.1).astype(np.float32)
    call(wav)
    seen = []
    fn = program.fn

    def guarded(*args):
        seen.append(args)
        with HostReadGuard():
            return fn(*args)

    program.fn = guarded
    call(wav)
    assert len(seen) == 1 and all(isinstance(a, torch.Tensor) for a in seen[0])


def _lstm_inputs():
    _, _, jtree, ttree = utmos_pair(7)
    feat = ttree["lstm"]["fwd"]["w_ih"].shape[1]
    x = np.random.default_rng(8).standard_normal((4, 37, feat)).astype(np.float32)
    return jtree["lstm"], ttree["lstm"], x, np.array([37, 20, 1, 29])


def test_masked_bilstm_matches_jax_on_valid_frames():
    jp, tp, x, lens = _lstm_inputs()
    valid = np.arange(x.shape[1])[None, :] < lens[:, None]
    want = np.asarray(jutmos.bilstm(jp, jnp.asarray(x), jnp.asarray(valid)))
    with torch.no_grad():
        got = n(tutmos.BiLSTM(tp)(t(x), t(lens, torch.int64)))
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL, rtol=RTOL)
    assert not got[~valid].any()  # pad frames are zero
    with torch.no_grad():
        whole = n(tutmos.BiLSTM(tp)(t(x)))
    np.testing.assert_allclose(whole, np.asarray(jutmos.bilstm(jp, jnp.asarray(x))), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("masked", [True, False], ids=["lengths", "whole"])
def test_masked_bilstm_matches_a_packed_lstm(masked):
    _, tp, x, lens = _lstm_inputs()
    lengths = t(lens, torch.int64) if masked else None
    with torch.no_grad():
        got, want = tutmos.BiLSTM(tp)(t(x), lengths), PackedBiLSTM(tp)(t(x), lengths)
    assert got.shape == want.shape == (4, 37, 2 * tp["fwd"]["w_hh"].shape[1])
    assert float((got - want).abs().max()) <= 1e-6


def test_reverse_within_is_its_own_inverse():
    x = torch.arange(2 * 5, dtype=torch.float32).reshape(2, 5, 1)
    lens = torch.tensor([3, 5])
    r = tutmos.reverse_within(x, lens)
    assert r[..., 0].tolist() == [[2, 1, 0, 3, 4], [9, 8, 7, 6, 5]]
    assert torch.equal(tutmos.reverse_within(r, lens), x)
