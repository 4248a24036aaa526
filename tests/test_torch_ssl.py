"""The port's SSL towers (``models/ssl.py``) and their state-dict converters
against the JAX package's, on the CPU at tiny widths.

The same numpy-seeded tree goes into both packages (the JAX tree through
``ssl_params_from_jax``, which unstacks its ``lax.scan`` layers), with every
leaf perturbed so no bias is zero and no norm is the identity.  Tolerance:
atol 1e-5 + rtol 1e-4 (both run f32; JAX at ``Precision.HIGHEST``).
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from simwhisper_codec_tpu.models import ssl as jssl
from simwhisper_codec_tpu_torch.models import ssl as tssl
from simwhisper_codec_tpu_torch.utils.ssl_checkpoint import ssl_params_from_jax

from torch_port import n, t

SSL_KW = dict(d_model=32, num_layers=2, num_heads=4, ffn_dim=64, conv_dims=(16, 16), conv_kernels=(10, 4),
              conv_strides=(5, 4), conv_pos_kernel=16, conv_pos_groups=4)
MSFT_KW = dict(pre_ln=True, extract_norm="layer", conv_bias=True, rel_pos_bias=True, num_buckets=8, max_distance=16)
# the JAX package's tiny tower configs (tests/test_tower_weights.py)
CONFIGS = {"fairseq": SSL_KW, "msft": dict(SSL_KW, **MSFT_KW)}
ATOL, RTOL = 1e-5, 1e-4


def perturbed(tree, seed: int):
    """A JAX tree with numpy leaves, each + 0.05 N(0, 1)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a))).astype(np.float32), tree)


def ssl_pair(name: str, seed: int = 0):
    jcfg, tcfg = jssl.SSLConfig(**CONFIGS[name]), tssl.SSLConfig(**CONFIGS[name])
    jtree = perturbed(jssl.init_ssl_params(jax.random.PRNGKey(seed), jcfg), seed + 100)
    return jcfg, tcfg, jtree, ssl_params_from_jax(jtree)


def batch(seed: int = 1, lens=(4000, 2700)):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((len(lens), max(lens))) * 0.1).astype(np.float32)
    for i, m in enumerate(lens):
        wav[i, m:] = 0.0
    return wav, np.asarray(lens, np.int32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("masked", [False, True], ids=["exact", "lengths"])
def test_ssl_forward_matches_jax(name, masked):
    jcfg, tcfg, jtree, ttree = ssl_pair(name)
    wav, lens = batch()
    jout = jax.jit(partial(jssl.ssl_forward, jcfg))(jtree, wav, lens if masked else None)
    with torch.no_grad():
        tout = tssl.ssl_forward(tcfg, ttree, t(wav), t(lens, torch.int64) if masked else None)
    for key in ("x", "hidden_states"):
        np.testing.assert_allclose(n(tout[key]), np.asarray(jout[key]), atol=ATOL, rtol=RTOL, err_msg=key)
    assert tout["hidden_states"].shape[0] == tcfg.num_layers + 1
    if masked:
        np.testing.assert_array_equal(n(tout["frame_lengths"]), np.asarray(jout["frame_lengths"]))
    else:
        assert "frame_lengths" not in tout


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_padded_batch_equals_exact_length_runs(name):
    """Masked GroupNorm statistics and zeroed pads: each item of a padded
    batch equals its own exact-length run on the valid frames."""
    _, tcfg, _, ttree = ssl_pair(name, seed=3)
    wav, lens = batch(seed=4, lens=(4000, 2300))
    with torch.no_grad():
        out = tssl.ssl_forward(tcfg, ttree, t(wav), t(lens, torch.int64))
        for i, m in enumerate(lens):
            one = tssl.ssl_forward(tcfg, ttree, t(wav[i: i + 1, :m]))
            f = int(out["frame_lengths"][i])
            assert f == one["x"].shape[1]
            np.testing.assert_allclose(n(out["x"][i, :f]), n(one["x"][0]), atol=ATOL, rtol=RTOL)
            np.testing.assert_allclose(n(out["hidden_states"][:, i, :f]), n(one["hidden_states"][:, 0]),
                                       atol=ATOL, rtol=RTOL)


def test_relative_position_buckets_match_jax():
    cfg = jssl.wavlm_large_config()
    for length in (1, 7, 400, 1599):
        np.testing.assert_array_equal(tssl.relative_position_buckets(tssl.wavlm_large_config(), length),
                                      jssl._relative_position_buckets(cfg, length))


def test_published_configs_match_jax():
    for name in ("wav2vec2_base_config", "hubert_base_config", "hubert_large_ft_config", "wavlm_large_config"):
        assert getattr(tssl, name)().__dict__ == getattr(jssl, name)().__dict__, name


def test_init_ssl_params_shapes_match_jax():
    for name in ("fairseq", "msft"):
        jcfg, tcfg = jssl.SSLConfig(**CONFIGS[name]), tssl.SSLConfig(**CONFIGS[name])
        want = dict(tssl.tree_leaves(ssl_params_from_jax(jax.tree.map(np.asarray, jssl.init_ssl_params(
            jax.random.PRNGKey(0), jcfg)))))
        got = dict(tssl.tree_leaves(tssl.init_ssl_params(tcfg, torch.Generator().manual_seed(0))))
        assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape) for k, v in want.items()}
