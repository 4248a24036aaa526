"""The port's variant modules against the JAX package's, on the CPU at small
widths: the forward STFT and MDCT / IMDCT (``ops/stft.py``), the Vocos
variants (``models/vocos_variants.py``), the generic Transformer, the
semantic encoder branch and the encoder's hidden states
(``models/transformer.py``), and the converters that carry their weights
(``utils/checkpoint.py``).

The same numpy inputs and weights go into both packages; the JAX package
runs at ``Precision.HIGHEST``, its attention kernels in interpret mode.
Each tolerance is written at its assertion.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simwhisper_codec_tpu.config import EncoderConfig as JEncoderConfig
from simwhisper_codec_tpu.models import transformer as jt
from simwhisper_codec_tpu.models import vocos_variants as jvv
from simwhisper_codec_tpu.ops import stft as jstft
from simwhisper_codec_tpu.utils.checkpoint import _linear as j_linear
from simwhisper_codec_tpu_torch.config import EncoderConfig
from simwhisper_codec_tpu_torch.models import transformer as tt
from simwhisper_codec_tpu_torch.models import vocos_variants as tvv
from simwhisper_codec_tpu_torch.ops import stft as tstft
from simwhisper_codec_tpu_torch.utils import checkpoint as ck

from torch_port import HIGHEST, n, t

ENC_KW = dict(num_mel_bins=20, d_model=64, encoder_layers=2, encoder_attention_heads=4, encoder_ffn_dim=128)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def wrapped_phase_err(a, b) -> np.ndarray:
    return np.abs(np.angle(np.exp(1j * (a.astype(np.float64) - b.astype(np.float64)))))


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("win_length", [64, 48])
def test_stft_log_mag_phase_matches_jax(center, win_length):
    """log |STFT| within 1e-4; the phase within 1e-4 (wrapped) where |STFT| > 1e-3,
    since it is ill-conditioned near 0."""
    x = np.random.default_rng(0).standard_normal((2, 1000)).astype(np.float32)
    jm, jp = jstft.stft_log_mag_phase(jstft.make_stft_constants(64, 16, win_length, center), jnp.asarray(x))
    tm, tp = tstft.stft_log_mag_phase(tstft.make_stft_constants(64, 16, win_length, center), t(x))
    assert tm.shape == jm.shape and tp.shape == jp.shape
    np.testing.assert_allclose(n(tm), n(jm), atol=1e-4)
    sure = np.exp(n(jm)) - 1e-5 > 1e-3
    assert sure.mean() > 0.9
    assert wrapped_phase_err(n(tp), n(jp))[sure].max() <= 1e-4


@pytest.mark.parametrize("padding", ["same", "center"])
def test_mdct_imdct_match_jax(padding):
    """MDCT of unit-scale audio and IMDCT of unit-scale coefficients within 1e-5;
    the window and twiddles equal."""
    rng = np.random.default_rng(1)
    audio = rng.standard_normal((2, 640)).astype(np.float32)
    coeffs = rng.standard_normal((2, 21, 16)).astype(np.float32)
    jc, tc = jstft.make_mdct_constants(32, padding), tstft.make_mdct_constants(32, padding)
    np.testing.assert_array_equal(n(tc.window), jc.window)
    for name in ("pre_twiddle", "post_twiddle", "ipre_twiddle", "ipost_twiddle"):
        np.testing.assert_array_equal(n(getattr(tc, name)), getattr(jc, name).astype(np.complex64))
    want = np.asarray(jstft.mdct(jc, jnp.asarray(audio)))
    got = n(tstft.mdct(tc, t(audio)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    want = np.asarray(jstft.imdct(jc, jnp.asarray(coeffs)))
    got = n(tstft.imdct(tc, t(coeffs)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def weight_normed_conv(rng, sd, prefix, cin, cout, k):
    v = rng.standard_normal((cout, cin, k)) * 0.2
    sd[f"{prefix}.weight_v"] = v.astype(np.float32)
    sd[f"{prefix}.weight_g"] = (np.sqrt((v * v).sum((1, 2), keepdims=True))
                                * (1 + 0.1 * rng.standard_normal((cout, 1, 1)))).astype(np.float32)
    sd[f"{prefix}.bias"] = (rng.standard_normal(cout) * 0.1).astype(np.float32)


def reference_resnet_state(seed: int, cin: int, dim: int, blocks: int) -> dict:
    """A reference-layout ``VocosResNetBackbone`` state dict (weight norm, gamma (C, 1))."""
    rng = np.random.default_rng(seed)
    sd = {}
    weight_normed_conv(rng, sd, "embed", cin, dim, 3)
    for i in range(blocks):
        for j in range(3):
            weight_normed_conv(rng, sd, f"resnet.{i}.convs1.{j}", dim, dim, 3)
            weight_normed_conv(rng, sd, f"resnet.{i}.convs2.{j}", dim, dim, 3)
            sd[f"resnet.{i}.gamma.{j}"] = (0.3 + 0.1 * rng.standard_normal((dim, 1))).astype(np.float32)
    return sd


def test_resnet_backbone_matches_jax():
    """The JAX converter's tree into both packages, and the reference state dict
    through the port's weight-norm fold: each within 3e-5 of JAX."""
    sd = reference_resnet_state(2, 12, 24, 2)
    tree = np_tree(jvv.convert_vocos_resnet_backbone(sd, "", num_blocks=2))
    x = np.random.default_rng(3).standard_normal((2, 30, 12)).astype(np.float32)
    want = np.asarray(jvv.vocos_resnet_backbone(tree, jnp.asarray(x)))
    from_jax = tvv.VocosResNetBackbone(12, 24, 2)
    from_jax.load_state_dict(ck.resnet_backbone_state_from_jax(tree))
    from_ref = tvv.VocosResNetBackbone(12, 24, 2)
    from_ref.load_state_dict(ck.reference_state_dict({k: t(v) for k, v in sd.items()}, from_ref))
    with torch.no_grad():
        for model in (from_jax, from_ref):
            np.testing.assert_allclose(n(model(t(x))), want, atol=3e-5)


@pytest.mark.parametrize("head", ["symexp", "cos"])
def test_imdct_heads_match_jax(head):
    """Linear -> symexp or exp/cos -> IMDCT within 1e-4, with and without clip_audio."""
    rng = np.random.default_rng(4)
    out_dim = 16 if head == "symexp" else 32
    sd = {"out.weight": (rng.standard_normal((out_dim, 16)) * 0.5).astype(np.float32),
          "out.bias": (rng.standard_normal(out_dim) * 0.1).astype(np.float32)}
    tree = {"out": j_linear(sd, "out")}
    x = (rng.standard_normal((2, 10, 16)) * 0.8).astype(np.float32)
    consts = jvv.IMDCTHeadConstants(32)
    jfn = jvv.imdct_symexp_head if head == "symexp" else jvv.imdct_cos_head
    cls = tvv.IMDCTSymExpHead if head == "symexp" else tvv.IMDCTCosHead
    for clip in (False, True):
        want = np.asarray(jfn(consts, tree, jnp.asarray(x), clip_audio=clip))
        model = cls(16, 32, clip_audio=clip)
        model.load_state_dict(ck.imdct_head_state_from_jax(tree))
        with torch.no_grad():
            got = n(model(t(x)))
        assert got.shape == want.shape == (2, 160)
        np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("cond", [np.array(3), np.array([0, 3])])
def test_ada_layer_norm_matches_jax(cond):
    """Scalar and per-sample class ids, within 1e-5."""
    rng = np.random.default_rng(5)
    p = {"scale": (1 + 0.1 * rng.standard_normal((4, 8))).astype(np.float32),
         "shift": (0.1 * rng.standard_normal((4, 8))).astype(np.float32)}
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    want = np.asarray(jvv.ada_layer_norm(p, jnp.asarray(x), jnp.asarray(cond)))
    model = tvv.AdaLayerNorm(4, 8)
    model.load_state_dict({"scale.weight": t(p["scale"]), "shift.weight": t(p["shift"])})
    with torch.no_grad():
        np.testing.assert_allclose(n(model(t(x), t(cond))), want, atol=1e-5)


def test_generic_transformer_matches_jax():
    """Final output (masked) and the L + 1 hidden states, which stay unmasked,
    within 5e-5."""
    tree = np_tree({"layers": jt._stack_layers(jax.random.split(jax.random.PRNGKey(6), 2), 32, 64),
                    "ln": {"scale": jnp.ones(32), "bias": jnp.zeros(32)}})
    pos = jt.sinusoids(50, 32)
    x = np.random.default_rng(7).standard_normal((2, 20, 32)).astype(np.float32)
    lens = np.array([20, 9])
    jy, jl, jstates = jt.generic_transformer_forward(tree, jnp.asarray(x), jnp.asarray(lens), 4, jnp.asarray(pos),
                                                     precision=HIGHEST, output_hidden_states=True)
    model = tt.GenericTransformer(32, 4, 64, 2, 50).eval()
    model.load_state_dict(ck.generic_transformer_state_from_jax(tree))
    with torch.no_grad():
        y, l, states = model(t(x), t(lens), output_hidden_states=True)
        y_only, _ = model(t(x), t(lens))
    np.testing.assert_array_equal(n(l), lens)
    np.testing.assert_allclose(n(y), np.asarray(jy), atol=5e-5)
    np.testing.assert_array_equal(n(y_only), n(y))
    assert states.shape == (3, 2, 20, 32)
    assert float(np.abs(n(states)[:, 1, 9:]).min()) > 0  # padding rows are not zeroed
    np.testing.assert_allclose(n(states), np.asarray(jstates), atol=5e-5)


def encoder_pair(is_acoustic: bool, seed: int = 8):
    jcfg, tcfg = JEncoderConfig(is_acoustic=is_acoustic, **ENC_KW), EncoderConfig(is_acoustic=is_acoustic, **ENC_KW)
    tree = np_tree(jt.init_encoder(jax.random.PRNGKey(seed), jcfg))
    model = tt.Encoder(tcfg).eval()
    model.load_state_dict(ck.encoder_state_from_jax(tree))
    return jcfg, tree, model


def mel_batch(seed: int = 9, lens=(64, 41)):
    mel = np.random.default_rng(seed).standard_normal((len(lens), max(lens), ENC_KW["num_mel_bins"]))
    return mel.astype(np.float32), np.array(lens)


def test_semantic_encoder_matches_jax():
    """is_acoustic=False (exact GELU after each conv, then the sinusoids) within
    5e-5, hidden states too; the positions equal the JAX package's and add no
    state-dict key."""
    jcfg, tree, model = encoder_pair(False)
    pos = jt.sinusoids(jcfg.max_source_positions, jcfg.d_model)
    np.testing.assert_array_equal(n(tt.sinusoids(jcfg.max_source_positions, jcfg.d_model)), pos)
    assert set(model.state_dict()) == set(tt.Encoder(EncoderConfig(**ENC_KW)).state_dict())
    mel, lens = mel_batch()
    jy, jl, jstates = jt.encoder_forward(jcfg, tree, jnp.asarray(mel), jnp.asarray(lens), pos_emb=jnp.asarray(pos),
                                         precision=HIGHEST, output_hidden_states=True)
    with torch.no_grad():
        y, l = model(t(mel), t(lens))
        _, _, states = model(t(mel), t(lens), output_hidden_states=True)
    np.testing.assert_array_equal(n(l), np.asarray(jl))
    np.testing.assert_allclose(n(y), np.asarray(jy), atol=5e-5)
    np.testing.assert_allclose(n(states), np.asarray(jstates), atol=5e-5)


@pytest.mark.parametrize("attn_impl", ["dense", "pflash", "flash"])
def test_encoder_hidden_states_match_jax(attn_impl):
    """output_hidden_states=True on the acoustic encoder: the final output and the
    L + 1 states (each masked past its length) within 5e-5 of the JAX function
    with the same attn_impl (its Pallas kernels in interpret mode; the port's
    kernel wrappers run their plain versions on CPU tensors)."""
    jcfg, tree, model = encoder_pair(True)
    mel, lens = mel_batch()
    jy, jl, jstates = jt.encoder_forward(jcfg, tree, jnp.asarray(mel), jnp.asarray(lens), precision=HIGHEST,
                                         output_hidden_states=True, attn_impl=attn_impl)
    with torch.no_grad():
        y, l, states = model(t(mel), t(lens), attn_impl=attn_impl, output_hidden_states=True)
        y_only, _ = model(t(mel), t(lens), attn_impl=attn_impl)
    assert states.shape == (jcfg.encoder_layers + 1, 2, 32, jcfg.d_model)
    np.testing.assert_array_equal(n(l), np.asarray(jl))
    np.testing.assert_allclose(n(y), np.asarray(jy), atol=5e-5)
    np.testing.assert_array_equal(n(y_only), n(y))
    np.testing.assert_allclose(n(states), np.asarray(jstates), atol=5e-5)
    assert not n(states)[:, 1, 20:].any()


def test_hidden_states_refuse_a_non_dense_ffn():
    _, _, model = encoder_pair(True)
    mel, lens = mel_batch()
    with pytest.raises(ValueError, match="dense FFN"):
        model(t(mel), t(lens), ffn_impl="fused", output_hidden_states=True)


def test_reference_checkpoint_with_positions_loads(tmp_path):
    """A reference-layout codec checkpoint whose semantic encoder carries
    ``embed_positions.weight`` loads into the
    port's Encoder, alone and under the ``acoustic_encoder.`` prefix, and gives
    the JAX function's output."""
    from simwhisper_codec_tpu_torch.experiments.hifigan_continue.extract_features import build_encoder_params

    jcfg, tree, model = encoder_pair(False)
    sd = dict(model.state_dict())
    sd["embed_positions.weight"] = torch.randn(jcfg.max_source_positions, jcfg.d_model)
    torch.save(sd, tmp_path / "encoder.pt")
    torch.save({"model": {f"acoustic_encoder.{k}": v for k, v in sd.items()}}, tmp_path / "codec.pt")
    loaded = ck.load_reference_checkpoint(tt.Encoder(EncoderConfig(is_acoustic=False, **ENC_KW)),
                                          str(tmp_path / "encoder.pt"))
    built = build_encoder_params(EncoderConfig(is_acoustic=False, **ENC_KW), str(tmp_path / "codec.pt"))
    mel, lens = mel_batch()
    jy, _ = jt.encoder_forward(jcfg, tree, jnp.asarray(mel), jnp.asarray(lens), precision=HIGHEST,
                               pos_emb=jnp.asarray(jt.sinusoids(jcfg.max_source_positions, jcfg.d_model)))
    with torch.no_grad():
        for enc in (loaded, built):
            np.testing.assert_allclose(n(enc(t(mel), t(lens))[0]), np.asarray(jy), atol=5e-5)
