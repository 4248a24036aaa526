"""The plain reference computes what the program's float32 (parity) path computes."""

import numpy as np
import torch

from benchmark import judge, traffic
from benchmark.reference import ReferenceCodec, float32_exact
from benchmark.weights import make_state, param_specs
from tiny import TINY_GP


def port_codec(state, mode):
    from simwhisper_codec_tpu_torch.config import CodecConfig
    from simwhisper_codec_tpu_torch.models.codec import AudioCodec, SimWhisperCodec

    with torch.device("meta"):
        model = SimWhisperCodec(CodecConfig.from_dict(TINY_GP))
    model.load_state_dict({k: v.clone() for k, v in state.items()}, strict=True, assign=True)
    return AudioCodec(CodecConfig.from_dict(TINY_GP), model, batch_size=3, mode=mode, device="cpu")


def test_weights_have_the_programs_keys_and_shapes():
    from simwhisper_codec_tpu_torch.config import CodecConfig
    from simwhisper_codec_tpu_torch.models.codec import SimWhisperCodec

    with torch.device("meta"):
        sd = SimWhisperCodec(CodecConfig.from_dict(TINY_GP)).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: s for k, s, _, _ in param_specs(TINY_GP)}
    a, b = make_state(TINY_GP, 2**40 + 3, "cpu"), make_state(TINY_GP, 2**40 + 3, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_reference_matches_the_programs_parity_mode():
    """Codes equal and waveforms within float32 rounding, over a three-chunk, a
    two-chunk and a one-chunk utterance, decoded in one batch (the width of
    the longest)."""
    state = make_state(TINY_GP, 123, "cpu")
    codec = port_codec(state, "parity")
    pool = traffic.noise_pool({"pool_seconds": 120, "noise_sigma": 0.1}, 0, 16000)
    wavs = traffic.slices(pool, np.array([47 * 16000, 213000, 25 * 16000 + 77]), 0)
    codes = codec.encode(wavs)["codes_list"]
    outs = codec.decode(codes)["syn_wav_list"]
    ref = ReferenceCodec(TINY_GP, state)
    with torch.no_grad(), float32_exact():
        enc = ref.encode(wavs)
        dec = ref.decode(codes, [max(c.shape[-1] for c in codes)] * 3)
    for c, (rc, lv), y, ry in zip(codes, enc, outs, dec):
        assert np.array_equal(c, rc)
        assert judge.code_gap(c, lv, [8, 7, 6, 6]) == 0.0
        assert judge.wav_err(y, ry) < 1e-5
