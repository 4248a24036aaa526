"""Orbax weights into the port, on the CPU at TINY: an Orbax params directory
written by the JAX package's ``save_orbax`` (``informative_params(0)``, so
the codes span the FSQ levels) is converted by ``tools/orbax_to_pt.py``;
the port serves the ``.pt`` with the codes that the JAX
``AudioCodec.load_from_checkpoint`` gives on the directory itself, and the
port's loader refuses the directory with an error that names the tool."""

import sys
from dataclasses import asdict

import numpy as np
import pytest
import yaml

from conftest import REPO_ROOT
from simwhisper_codec_tpu.config import load_config as jax_load_config
from simwhisper_codec_tpu.models import codec as jcodec
from simwhisper_codec_tpu.utils.checkpoint import save_orbax
from simwhisper_codec_tpu_torch.config import load_config
from simwhisper_codec_tpu_torch.models import codec as tcodec

from test_codec_e2e import GENERATOR_PARAMS
from torch_port import TINY, informative_params

sys.path.insert(0, str(REPO_ROOT / "tools"))
import orbax_to_pt  # noqa: E402  (the bridge tool)

SR = 16000


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("orbax")
    cfg = tmp / "tiny.yaml"
    params = dict(GENERATOR_PARAMS, vocos=dict(GENERATOR_PARAMS["vocos"], num_layers=TINY.vocos.num_layers),
                  acoustic_encoder=dict(GENERATOR_PARAMS["acoustic_encoder"], freeze=TINY.acoustic_encoder.freeze))
    cfg.write_text(yaml.safe_dump({"generator_params": params}))
    assert jax_load_config(str(cfg)) == TINY and asdict(load_config(str(cfg))) == asdict(TINY)
    save_orbax(str(tmp / "orbax"), informative_params(0))
    orbax_to_pt.main(["--config", str(cfg), "--orbax_dir", str(tmp / "orbax"), "--out", str(tmp / "codec.pt")])
    return cfg, tmp / "orbax", tmp / "codec.pt"


def test_converted_orbax_serves_the_jax_loaders_codes(converted):
    cfg, orbax_dir, pt = converted
    rng = np.random.default_rng(11)
    wavs = [(rng.standard_normal(k) * 0.1).astype(np.float32) for k in (100800, 23 * SR)]
    jc = jcodec.AudioCodec.load_from_checkpoint(str(cfg), str(orbax_dir), batch_size=2, mode="parity")
    tc = tcodec.AudioCodec.load_from_checkpoint(str(cfg), str(pt), batch_size=2, mode="parity", device="cpu")
    want = jc.encode(wavs)["codes_list"]
    got = tc.encode(wavs)["codes_list"]
    for a, b in zip(got, want):
        assert all(len(np.unique(group)) > 1 for group in a), "codes carry no information"
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(tc.decode(got)["syn_wav_list"], jc.decode(want)["syn_wav_list"]):
        assert a.shape == np.asarray(b).shape
        assert float(np.abs(a - np.asarray(b)).max()) < 5e-3


def test_port_loader_refuses_a_directory(converted):
    cfg, orbax_dir, _ = converted
    with pytest.raises(ValueError, match="tools/orbax_to_pt.py"):
        tcodec.AudioCodec.load_from_checkpoint(str(cfg), str(orbax_dir), device="cpu")
