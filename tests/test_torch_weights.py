"""Weights import of the PyTorch port and the independence of its package.

- JAX tree -> ``params_from_jax`` -> port -> ``state_dict()`` -> the JAX
  package's own reference-checkpoint converter -> the same tree, exactly:
  the port's module names are the reference's state-dict keys.
- A reference-layout ``.pt`` with weight norm and stray buffers loads into
  the port as it loads into the JAX package.
- Importing the port pulls in neither jax nor the JAX package (checked in a
  fresh interpreter: this test process has jax loaded already).
"""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from simwhisper_codec_tpu.config import CodecConfig as JaxCodecConfig
from simwhisper_codec_tpu.utils.checkpoint import convert_state_dict, load_codec_params
from simwhisper_codec_tpu_torch.config import CodecConfig
from simwhisper_codec_tpu_torch.models.codec import AudioCodec, SimWhisperCodec
from simwhisper_codec_tpu_torch.utils.checkpoint import load_reference_checkpoint, params_from_jax

from conftest import REPO_ROOT
from test_codec_e2e import GENERATOR_PARAMS
from torch_port import TINY, jax_params, port_model

WN_CONVS = ("in_proj", "to_latent", "from_latent", "to_stacked", ".block.1", ".block.3")


def _numpy_sd(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def test_state_dict_is_reference_layout_both_ways():
    params = jax_params(3)
    model = port_model(params)
    sd = _numpy_sd(model)
    assert "acoustic_encoder.layers.1.self_attn.q_proj.weight" in sd
    assert "acoustic_encoder.layers.0.self_attn.k_proj.bias" not in sd
    assert "vocos.backbone.convnext.1.pwconv1.weight" in sd and "vocos.head.out.bias" in sd
    assert not any(k.startswith("consts.") or "istft" in k for k in sd)  # constants are not weights
    back = convert_state_dict(sd, TINY)
    got, want = jax.tree_util.tree_flatten_with_path(back)[0], jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_reference_checkpoint_with_weight_norm(tmp_path):
    cfg = CodecConfig.from_dict(GENERATOR_PARAMS)
    params = jax_params(4, JaxCodecConfig.from_dict(GENERATOR_PARAMS))
    sd = params_from_jax(params)
    rng = np.random.default_rng(0)
    ref = {}
    for key, w in sd.items():
        if key.endswith(".weight") and any(m in key for m in WN_CONVS):
            c = torch.tensor(rng.uniform(0.5, 2.0, (w.shape[0], 1, 1)), dtype=torch.float32)
            v = w * c
            ref[key[:-6] + "weight_v"] = v
            ref[key[:-6] + "weight_g"] = torch.sqrt((v.double() ** 2).sum((1, 2), keepdim=True)).float() / c
        else:
            ref[key] = w
    ref["quantizer.fsqs.0.dim_base"] = torch.tensor([1, 8, 56, 336])  # a reference buffer the port recomputes
    path = tmp_path / "ref.pt"
    torch.save({"model": ref}, path)

    model = load_reference_checkpoint(SimWhisperCodec(cfg), str(path))
    jtree = load_codec_params(str(path), JaxCodecConfig.from_dict(GENERATOR_PARAMS), report=False)
    for key, value in params_from_jax(jtree).items():  # both importers fold to the same weights
        np.testing.assert_array_equal(model.state_dict()[key].numpy(), value.numpy(), err_msg=key)
    for key, value in sd.items():
        np.testing.assert_allclose(model.state_dict()[key].numpy(), value.numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=key)

    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump({"generator_params": GENERATOR_PARAMS}))
    codec = AudioCodec.load_from_checkpoint(str(config), str(path), mode="parity", device="cpu")
    assert codec.encode([np.zeros(2560, np.float32)])["codes_list"][0].shape == (8, 2)

    del ref["vocos.head.out.weight"]
    torch.save(ref, path)
    with pytest.raises(KeyError, match="vocos.head.out.weight"):
        load_reference_checkpoint(SimWhisperCodec(cfg), str(path))


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import simwhisper_codec_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'\n"
        "       or m == 'simwhisper_codec_tpu' or m.startswith('simwhisper_codec_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules if m.startswith('simwhisper_codec_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("clean") and int(out.stdout.split()[1]) >= 15


def test_port_sources_name_no_jax():
    files = sorted((REPO_ROOT / "simwhisper_codec_tpu_torch").rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "jax" not in s and "simwhisper_codec_tpu." not in s.replace("simwhisper_codec_tpu_torch", ""), \
                    f"{f}: {s}"
