"""The port's compiled serving programs (``utils/aot.py``) on the CPU.

(a) ``AudioCodec.trace_counts`` against the JAX package's on one call
    sequence: batches of 1, 2 and 3 utterances, an utterance whose last
    chunk is narrow, and a batch larger than ``batch_size``;
(b) ``detokenize`` at three chunk widths, each reaching the program as a
    device scalar, against the JAX ``detokenize`` with a traced
    ``code_frame_valid``: one program each;
(c) B4 and the Vocos with the width as a tensor against the width as an
    int, bit for bit;
(d) the kernel libraries' path: ``aot_dir`` / ``$SIMWHISPER_AOT_DIR``, the
    source digest and the ``nvcc`` version line; a library that does not
    load is rebuilt once;
(e) no host read (``.item()``, ``nonzero``) and no tensor made from host
    data inside ``tokenize`` / ``detokenize``, in every serving mode: a CUDA
    graph capture would refuse them;
(f) ``--aot_dir`` of the serve and inference twins reaches ``AudioCodec``;
(g) ``eager()`` gives the same results, counts nothing; a replay's result
    held by the caller survives the next replay.
The capture itself runs on the card only (``chip_smoke.py`` phase 3).
"""

import _ctypes
import collections
import logging
import shutil

import numpy as np
import pytest
import torch
import yaml
from torch.utils._python_dispatch import TorchDispatchMode

from simwhisper_codec_tpu.models import codec as jcodec
from simwhisper_codec_tpu_torch import inference, serve
from simwhisper_codec_tpu_torch.models import codec as tcodec
from simwhisper_codec_tpu_torch.models.vocos import ConvNeXtBlock
from simwhisper_codec_tpu_torch.ops import _cuda
from simwhisper_codec_tpu_torch.ops import fused_convnext as fc
from simwhisper_codec_tpu_torch.utils import aot

from test_codec_e2e import GENERATOR_PARAMS
from torch_port import TINY, jax_params, port_model

SR = 16000


@pytest.fixture(scope="module")
def pair():
    params = jax_params(0)
    return params, port_model(params)


def _noise(rng, seconds):
    return (rng.standard_normal(int(seconds * SR)) * 0.1).astype(np.float32)


def test_trace_counts_match_jax(pair):
    """One program per direction for batches of 1, 2 and 3 (padded to
    ``batch_size`` = 4) and for a 41 s utterance whose third chunk is 1 s
    wide; a batch of 5 is a second program each way, in both packages."""
    params, model = pair
    jc = jcodec.AudioCodec(TINY, params, batch_size=4, mode="parity")
    tc = tcodec.AudioCodec(TINY, model, batch_size=4, mode="parity", device="cpu")
    rng = np.random.default_rng(3)
    steps = [[_noise(rng, 1.25) for _ in range(n)] for n in (1, 2, 3)]
    steps += [[_noise(rng, 41.0)], [_noise(rng, 1.25) for _ in range(5)]]
    want = [{"tokenize": 1, "detokenize": 1}] * 4 + [{"tokenize": 2, "detokenize": 2}]
    for batch, counts in zip(steps, want):
        for codec in (jc, tc):
            codes = codec.encode(batch)["codes_list"]
            assert len(codec.decode(codes)["syn_wav_list"]) == len(batch)
        assert tc.trace_counts == jc.trace_counts == counts
    assert tc._tokenize.source == tc._detokenize.source == "eager"  # the CPU runs each program eagerly


def test_detokenize_width_is_a_device_scalar(pair):
    """Chunk widths 375 (a whole chunk), 200 and 37 through
    ``inference_detokenize``: the port's program takes each as a 0-d int32
    input, the JAX program as a traced scalar; waveforms within the codec
    parity tests' 3e-4 over the valid samples, one program each."""
    params, model = pair
    jc = jcodec.AudioCodec(TINY, params, batch_size=2, mode="parity")
    tc = tcodec.AudioCodec(TINY, model, batch_size=2, mode="parity", device="cpu")
    rng = np.random.default_rng(4)
    wav = np.stack([_noise(rng, 30.0), np.pad(_noise(rng, 12.5), (0, 17 * SR + SR // 2))])
    lens = np.array([30 * SR, 12.5 * SR], np.int64)
    tok = jc.inference_tokenize(wav, lens)
    codes, clen = np.asarray(tok["codes"]), np.asarray(tok["codes_lengths"])
    seen = []
    spy = tc._detokenize.fn
    tc._detokenize.fn = lambda c, n, w: seen.append(w) or spy(c, n, w)
    for width in (375, 200, 37):
        c, n = codes[:, :, :width], np.minimum(clen, width)
        want = np.asarray(jc.inference_detokenize(c, n, chunk_width=width)["y"])
        got = tc.inference_detokenize(c, n, chunk_width=width)["y"].numpy()
        keep = width * 1280
        np.testing.assert_allclose(got[:, :keep], want[:, :keep], atol=3e-4)
    assert [(w.shape, w.dtype, int(w)) for w in seen] == [((), torch.int32, w) for w in (375, 200, 37)]
    assert tc.trace_counts["detokenize"] == jc.trace_counts["detokenize"] == 1


@pytest.mark.parametrize("t,fv", [(40, 40), (40, 23), (40, 0), (40, 57), (1, 1)])
def test_b4_plain_tensor_width_equals_int_width(t, fv):
    """B4's plain version (what its wrapper runs on CPU tensors) and its
    depthwise sum with the width as a tensor equal the int width's, bit for bit."""
    gen = torch.Generator().manual_seed(t + fv)
    block = ConvNeXtBlock(64, 128, 0.1)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    x = torch.randn(2, t, 64, generator=gen).to(torch.bfloat16)
    with torch.no_grad():
        for width in (torch.tensor(fv), torch.tensor([fv], dtype=torch.int32)):
            assert torch.equal(fc._dw_sum_plain(x, block, width), fc._dw_sum_plain(x, block, fv))
            assert torch.equal(fc.fused_convnext_block_dw(x, block, width), fc.fused_convnext_block_dw(x, block, fv))


@pytest.mark.parametrize("impl", [None, "fused-dw"])
def test_vocos_tensor_width_equals_int_width(pair, impl):
    """The Vocos (edge mask, B4 in fused-dw, ISTFT envelope) with the width
    as a 0-d tensor equals the int width, bit for bit."""
    _, model = pair
    rng = np.random.default_rng(7)
    dtype = torch.float32 if impl is None else torch.bfloat16
    mel = torch.from_numpy(rng.standard_normal((2, 300, TINY.vocos.input_channels)).astype(np.float32)).to(dtype)
    lens = torch.tensor([300, 170])
    with torch.no_grad():
        for fv in (300, 171, 9):
            y_t, n_t = model.vocos(mel, lens, torch.tensor(fv, dtype=torch.int32), impl)
            y_i, n_i = model.vocos(mel, lens, fv, impl)
            assert torch.equal(y_t, y_i) and torch.equal(n_t, n_i)


def test_library_path_keys(monkeypatch, tmp_path):
    """lib<name>-<key>.so in ``build_dir()``: ``use_aot_dir`` first, then
    ``$SIMWHISPER_AOT_DIR``, then ``simwhisper_codec_tpu_torch/build``; the
    key changes with the nvcc version line and with any source or header."""
    monkeypatch.setattr(_cuda, "_aot_dir", None)
    monkeypatch.delenv(_cuda.AOT_ENV, raising=False)
    monkeypatch.setattr(_cuda, "nvcc_version", lambda: "Build cuda_12.4.r12.4/compiler.34097967_0")
    base = _cuda._library_path("convnext_dw")
    assert base.parent == _cuda.BUILD_DIR and base.name.startswith("libconvnext_dw-") and base.suffix == ".so"
    assert _cuda._library_path("convnext_dw") == base
    monkeypatch.setenv(_cuda.AOT_ENV, str(tmp_path / "env"))
    assert _cuda._library_path("convnext_dw") == tmp_path / "env" / base.name
    _cuda.use_aot_dir(tmp_path / "given")
    try:
        assert _cuda._library_path("convnext_dw") == tmp_path / "given" / base.name
    finally:
        _cuda.use_aot_dir(None)
    assert _cuda.build_dir() == tmp_path / "env"
    monkeypatch.delenv(_cuda.AOT_ENV)
    monkeypatch.setattr(_cuda, "nvcc_version", lambda: "Build cuda_12.8.r12.8/compiler.35404655_0")
    assert _cuda._library_path("convnext_dw").name != base.name
    monkeypatch.setattr(_cuda, "nvcc_version", lambda: "Build cuda_12.4.r12.4/compiler.34097967_0")
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC_DIR, csrc)
    monkeypatch.setattr(_cuda, "CSRC_DIR", csrc)
    assert _cuda._library_path("convnext_dw") == base
    (csrc / "sm90.cuh").write_text((csrc / "sm90.cuh").read_text() + "\n// edited\n")
    assert _cuda._library_path("convnext_dw").name != base.name


def test_a_library_that_does_not_load_is_rebuilt_once(monkeypatch, tmp_path, caplog):
    """A file under the library's key that ``dlopen`` refuses is rebuilt once,
    with a warning, then loaded; an existing library is loaded without nvcc."""
    monkeypatch.setattr(_cuda, "nvcc_version", lambda: "Build cuda_12.4.r12.4/compiler.34097967_0")
    monkeypatch.setattr(_cuda, "_libraries", {})
    builds = []

    def fake_nvcc(source, out, log):  # any shared library stands in for a kernel's
        builds.append(source.name)
        shutil.copy(_ctypes.__file__, out)
        return out

    monkeypatch.setattr(_cuda, "nvcc", fake_nvcc)
    _cuda.use_aot_dir(tmp_path)
    try:
        path = _cuda._library_path("flash")
        path.write_bytes(b"not a shared library")
        with caplog.at_level(logging.WARNING, logger=_cuda.__name__):
            _cuda.build_kernels(["flash"])
        assert builds == ["flash.cu"] and "rebuilding" in caplog.text and "flash" in _cuda._libraries
        _cuda._libraries.clear()
        _cuda.build_kernels(["flash"])
        assert builds == ["flash.cu"] and "flash" in _cuda._libraries
    finally:
        _cuda.use_aot_dir(None)


class HostReadGuard(TorchDispatchMode):
    """Fails on what a CUDA graph capture refuses: a read of a device value
    on the host (``.item()``, ``int(t)``, ``bool(t)``), a data-dependent
    shape (``nonzero``), a tensor made from host data (``torch.tensor``)."""

    REFUSED = ("aten::_local_scalar_dense", "aten::nonzero", "aten::lift_fresh")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in self.REFUSED:
            raise AssertionError(f"{func._schema.name} inside a captured program")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode,attn_impl,vocos_impl", [
    ("parity", None, None), ("fast", None, None), ("fast-int8", None, None), ("fast", "flash", "fused-dw"),
    ("parity", "pflash", None), ("parity", "flash", None)])
def test_programs_read_nothing_on_the_host(mode, attn_impl, vocos_impl):
    model = port_model(jax_params(0))
    codec = tcodec.AudioCodec(TINY, model, batch_size=2, mode=mode, device="cpu", attn_impl=attn_impl,
                              vocos_impl=vocos_impl)
    rng = np.random.default_rng(5)
    wav = torch.from_numpy((rng.standard_normal((2, TINY.chunk_samples)) * 0.1).astype(np.float32))
    lens, width = torch.tensor([TINY.chunk_samples, 3 * SR]), torch.tensor(200, dtype=torch.int32)
    with torch.no_grad(), tcodec.f32_precision(codec.precision):
        with HostReadGuard():
            tok = codec._tokenize.fn(wav, lens)
            out = codec._detokenize.fn(tok["codes"], tok["codes_lengths"], width)
    assert out["y"].shape == (2, TINY.code_frames * 1280)
    with pytest.raises(AssertionError, match="_local_scalar_dense"), HostReadGuard():
        int(lens[0])


def test_aot_dir_reaches_the_codec_from_both_clis(monkeypatch, tmp_path):
    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump({"generator_params": GENERATOR_PARAMS}))
    args = serve.build_parser().parse_args(["--config", str(config), "--device", "cpu", "--mode", "parity",
                                            "--aot_dir", str(tmp_path / "aot")])
    assert args.aot_dir == str(tmp_path / "aot")
    assert serve.build_codec(args).aot_dir == str(tmp_path / "aot")
    assert serve.build_parser().parse_args([]).aot_dir is None

    class Stop(Exception):
        pass

    seen = {}

    def load(**kwargs):
        seen.update(kwargs)
        raise Stop

    monkeypatch.setattr(inference.AudioCodec, "load_from_checkpoint", load)
    for argv, want in ((["--aot_dir", str(tmp_path / "aot")], str(tmp_path / "aot")), ([], None)):
        with pytest.raises(Stop):
            inference.main(["--device", "cpu", *argv])
        assert seen["aot_dir"] == want


def test_eager_gives_the_same_results_and_counts_nothing(pair):
    _, model = pair
    codec = tcodec.AudioCodec(TINY, model, batch_size=2, mode="parity", device="cpu")
    wavs = [_noise(np.random.default_rng(9), 2.5)]
    with aot.eager():
        codes_eager = codec.encode(wavs)["codes_list"]
        y_eager = codec.decode(codes_eager)["syn_wav_list"]
        assert codec.trace_counts == {"tokenize": 0, "detokenize": 0} and codec._tokenize.source == "eager"
    codes = codec.encode(wavs)["codes_list"]
    y = codec.decode(codes)["syn_wav_list"]
    assert codec.trace_counts == {"tokenize": 1, "detokenize": 1}
    np.testing.assert_array_equal(codes[0], codes_eager[0])
    np.testing.assert_array_equal(y[0], y_eager[0])


def test_a_held_replay_result_survives_the_next_replay(monkeypatch):
    """Each replay returns clones of the static outputs and adds the launches
    recorded at capture to the counts (a stand-in graph doubles its input)."""
    monkeypatch.setattr(_cuda, "launch_counts", collections.defaultdict(int))
    static_in, static_out = torch.zeros(3), {"y": torch.zeros(3)}

    class Graph:
        def replay(self):
            static_out["y"].copy_(static_in * 2)

    g = aot._Graph(Graph(), [static_in], static_out, {"kernel:64x128": 3})
    first = g.replay([torch.tensor([1.0, 2.0, 3.0])])
    second = g.replay([torch.tensor([5.0, 6.0, 7.0])])
    assert torch.equal(first["y"], torch.tensor([2.0, 4.0, 6.0]))
    assert torch.equal(second["y"], torch.tensor([10.0, 12.0, 14.0]))
    assert dict(_cuda.launch_counts) == {"kernel:64x128": 6}


def test_a_program_takes_tensors_on_one_device():
    program = aot.CapturedProgram(lambda x: {"y": x + 1}, "f")
    assert torch.equal(program(torch.ones(2))["y"], torch.full((2,), 2.0)) and program.count == 1
    program(torch.ones(2))
    program(torch.ones(3))
    assert program.count == 2
    with torch.backends.cudnn.flags(enabled=True, deterministic=not torch.backends.cudnn.deterministic):
        program(torch.ones(3))  # a math flag a capture would bake in: another program
    assert program.count == 3
    with pytest.raises(TypeError):
        program(3)


def test_a_sharded_model_runs_eagerly(caplog):
    """Layers holding a model group (``parallel.mesh.shard_model``) make both
    programs eager, logged: their collectives cannot be captured."""
    model = port_model(jax_params(0))
    model.vocos.backbone.convnext[0].model_group = object()  # as shard_model marks a sharded layer
    with caplog.at_level(logging.INFO, logger=tcodec.__name__):
        codec = tcodec.AudioCodec(TINY, model, batch_size=2, mode="parity", device="cpu")
    assert "run eagerly" in caplog.text
    assert not codec._tokenize._capture and not codec._detokenize._capture
    plain = tcodec.AudioCodec(TINY, port_model(jax_params(0)), batch_size=2, mode="parity", device="cpu")
    assert plain._tokenize._capture and plain._detokenize._capture
