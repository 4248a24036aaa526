"""The port's FLOP ledger, profiling helpers and checkpoint checksum report,
on the CPU, against the JAX package's:

 - ``codec_flops`` gives the JAX dict integer for integer, at
   ``CodecConfig()`` and at TINY; ``peak_tflops`` reads NVIDIA names;
 - ``trace`` writes a trace that names the ``annotate`` regions;
   ``StageTimer`` keeps the JAX report format;
 - ``param_checksum_report`` on a ``.pt`` against the JAX report on the same
   file: each JAX leaf against the port tensors it maps to through
   ``params_from_jax`` (a stacked leaf is one tensor a layer in the port);
   ``load_reference_checkpoint`` logs the report.
"""

import glob
import json
import logging
import re
from dataclasses import asdict

import jax
import numpy as np
import pytest
import torch

from simwhisper_codec_tpu.config import CodecConfig as JaxCodecConfig
from simwhisper_codec_tpu.utils import checkpoint as jckpt
from simwhisper_codec_tpu.utils import flops as jflops
from simwhisper_codec_tpu.utils import profiling as jprofiling
from simwhisper_codec_tpu_torch.config import CodecConfig
from simwhisper_codec_tpu_torch.models.codec import SimWhisperCodec
from simwhisper_codec_tpu_torch.utils import checkpoint as tckpt
from simwhisper_codec_tpu_torch.utils import flops, profiling
from simwhisper_codec_tpu_torch.utils.checkpoint import params_from_jax

from torch_port import TINY, informative_params, port_model


@pytest.mark.parametrize("name", ["default", "tiny"])
def test_ledger_equals_jax(name):
    jcfg = JaxCodecConfig() if name == "default" else TINY
    cfg = CodecConfig() if name == "default" else CodecConfig.from_dict(asdict(TINY))
    assert asdict(cfg) == asdict(jcfg)
    got, want = flops.codec_flops(cfg), jflops.codec_flops(jcfg)
    assert got == want and all(isinstance(v, int) for v in got.values())
    assert got["total"] == got["total_tokenize"] + got["total_detokenize"]


def test_peak_tflops_by_name():
    assert flops.peak_tflops("NVIDIA H100 80GB HBM3") == 989.4
    assert flops.peak_tflops("NVIDIA H100 SXM5 80GB") == 989.4
    assert flops.peak_tflops("NVIDIA H100 PCIe") == 756.0
    assert flops.peak_tflops("NVIDIA H100 NVL") == 835.0
    assert flops.peak_tflops("TPU v5 lite") == 0.0  # no TPU table in the port
    assert flops.peak_tflops("cpu") == flops.peak_tflops(torch.device("cpu")) == 0.0


def test_trace_names_the_annotated_regions(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("tokenize_region"):
            x = torch.randn(64, 64) @ torch.randn(64, 64)
        with profiling.annotate("detokenize_region"):
            torch.relu(x)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(open(files[0]).read())["traceEvents"]}
    assert {"tokenize_region", "detokenize_region"} <= names and "aten::mm" in names


def test_stage_timer_keeps_the_jax_format(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("a CPU tensor needs no sync"))
    timer = profiling.StageTimer(sync=True)
    x = torch.ones(4)
    with timer.stage("encode", block_on={"y": [x]}):
        pass
    with timer.stage("encode", block_on=x):
        pass
    assert timer.counts == {"encode": 2}
    jtimer = jprofiling.StageTimer()
    for t in (timer, jtimer):
        t.reset()
        t.totals.update({"tokenize": 1.25, "detokenize": 2.5, "vocos": 0.125})
        t.counts.update({"tokenize": 3, "detokenize": 3, "vocos": 1})
    assert timer.report() == jtimer.report()
    assert timer.report().splitlines()[1].startswith("detokenize")


# -- checksum report --------------------------------------------------------------

LINE = re.compile(r"^(\S+)\s+(\[[0-9, ]*\])\s+mean=(\S+) std=(\S+) xor32=([0-9a-f]{8})$")


def parse(report: str) -> dict:
    out = {}
    for line in report.splitlines():
        m = LINE.match(line)
        assert m, line
        out[m[1]] = {"size": int(np.prod(json.loads(m[2]), dtype=np.int64)), "mean": float(m[3]),
                     "std": float(m[4]), "xor": int(m[5], 16)}
    return out


def leaf_of_each_port_key(params) -> dict:
    """Port state-dict key -> JAX leaf path, through the ``params_from_jax``
    layout: every JAX leaf is filled with its own index, and each port tensor
    holds the index of the leaf it came from."""
    paths, leaves = zip(*jax.tree_util.tree_leaves_with_path(params))
    ids = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params),
                                       [np.full(np.shape(a), i, np.float32) for i, a in enumerate(leaves)])
    out = {}
    for key, tensor in params_from_jax(ids).items():
        values = torch.unique(tensor)
        assert values.numel() == 1, key
        out[key] = jax.tree_util.keystr(paths[int(values)])
    return out


def weight_normed(sd: dict, rng) -> tuple:
    """``sd`` with the sampler convs in the reference's old weight-norm keys
    (the JAX loader folds exactly these); returns it and their prefixes."""
    out, folded = {}, []
    for key, w in sd.items():
        if key.startswith(("downsample.", "upsample.")) and key.endswith(".weight") and w.dim() == 3:
            prefix = key[: -len(".weight")]
            g = w.norm(dim=(1, 2), keepdim=True) * torch.from_numpy(rng.uniform(0.5, 2.0, (w.shape[0], 1, 1)))
            out[prefix + ".weight_g"] = g.to(torch.float32)
            out[prefix + ".weight_v"] = w * 3.0
            folded.append(prefix)
        else:
            out[key] = w
    return out, folded


def test_checksum_report_matches_jax(tmp_path, caplog):
    params = informative_params(0)
    sd, folded = weight_normed(port_model(params).state_dict(), np.random.default_rng(0))
    assert len(folded) > 4
    torch.save({"model": sd}, tmp_path / "codec.pt")

    with caplog.at_level(logging.INFO):
        jreport = parse(jckpt.param_checksum_report(jckpt.load_codec_params(str(tmp_path / "codec.pt"), TINY)))
        model = tckpt.load_reference_checkpoint(SimWhisperCodec(TINY), str(tmp_path / "codec.pt"))
    report = tckpt.param_checksum_report(model)
    assert tckpt.param_checksum_report(model.state_dict()) == report
    logged = [r.getMessage() for r in caplog.records if r.name == tckpt.__name__]
    assert logged == [f"checkpoint {tmp_path / 'codec.pt'} tensor report:\n{report}"]

    port = parse(report)
    owner = leaf_of_each_port_key(params)
    assert set(owner) == set(port) and set(owner.values()) == set(jreport)
    xor_differs = []
    for path, want in jreport.items():
        keys = [k for k, p in owner.items() if p == path]
        size = sum(port[k]["size"] for k in keys)
        assert size == want["size"], path
        mean = sum(port[k]["size"] * port[k]["mean"] for k in keys) / size
        second = sum(port[k]["size"] * (port[k]["std"] ** 2 + port[k]["mean"] ** 2) for k in keys) / size
        std = np.sqrt(max(second - mean * mean, 0.0))
        # relative to the tensor's spread: a mean near 0 has no digits of its own
        assert abs(mean - want["mean"]) <= 1e-6 * max(abs(want["mean"]), want["std"]), (path, mean, want)
        assert abs(std - want["std"]) <= 1e-6 * want["std"] + 1e-12, (path, std, want)
        xor = 0
        for k in keys:
            xor ^= port[k]["xor"]
        if xor != want["xor"]:
            xor_differs.append((path, keys))
    # Only a weight-norm fold may differ, by rounding: both loaders fold in
    # float64 (w = g v / ||v||), numpy and torch sum ||v|| in different
    # orders, and a product that lands within an ulp of a float32 rounding
    # boundary can round the other way.  Every other tensor is copied (and
    # transposed) bit for bit.
    folded_keys = {p + ".weight" for p in folded}
    for path, keys in xor_differs:
        assert set(keys) <= folded_keys, (path, keys)
    print(f"xor32 equal on {len(jreport) - len(xor_differs)} of {len(jreport)} JAX leaves; "
          f"differing (weight-norm folds): {[p for p, _ in xor_differs]}")
