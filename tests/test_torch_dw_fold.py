"""The Vocos ConvNeXt block's depthwise conv folded into the rows pass of B2 and B3.

On a CUDA device the ``int8`` and ``fused`` blocks run the masked depthwise
k7 conv inside their kernel's rows pass (``csrc/dw_rows.cuh``,
``ops/fused_convnext.py::fused_convnext_block``), rounded where the plain
chain rounds, so that codes and waveforms stay the plain chain's bit for
bit.  On the CPU the block runs the plain chain.  Checked here:

- the block on the CPU against the plain chain as it was written before the
  fold (edge-mask multiply, ``depthwise_conv1d_shifts``, then the FFN chain);
- a model of the rows pass's arithmetic (its window, edge and roundings,
  tile by tile) against the plain conv, bit for bit;
- on the ``meta`` device with the launch recorded: a block launches one
  folded call under the unfolded launch key and runs no plain conv, a
  transformer FFN launches the unfolded kernel, and a Vocos forward makes
  its edge bound once;
- every row and pass kernel of ``csrc/ln_ffn.cu`` and ``csrc/ln_ffn_int8.cu``
  is named as ``benchmark/yardstick.py``'s kernel groups expect.

The ``chip`` test holds the kernels themselves to the plain chain on the card
(``python -m pytest --noconftest -m chip tests/test_torch_dw_fold.py``).
"""

import ctypes
import re

import pytest
import torch

from simwhisper_codec_tpu_torch.config import VocosConfig
from simwhisper_codec_tpu_torch.models import transformer as tmod
from simwhisper_codec_tpu_torch.models import vocos as vmod
from simwhisper_codec_tpu_torch.models.vocos import ConvNeXtBlock, Vocos, edge_mask
from simwhisper_codec_tpu_torch.ops import _cuda
from simwhisper_codec_tpu_torch.ops import fused_convnext as fc
from simwhisper_codec_tpu_torch.ops.conv import depthwise_conv1d_shifts
from simwhisper_codec_tpu_torch.ops.quant import quantize_stacked_convnext, quantize_stacked_ffn

ROWS, HALO = 32, 3  # csrc/dw_rows.cuh: a block's time rows, the conv's half width


def random_block(c, inter, seed, device="cpu"):
    """A block with every parameter drawn (biases included, which the init zeroes), int8 weights added."""
    gen = torch.Generator().manual_seed(seed)
    block = ConvNeXtBlock(c, inter, 1.0 / 24)
    with torch.no_grad():
        for name, p in block.named_parameters():
            scale = {"dwconv.weight": 0.3, "norm.weight": 0.1}.get(name, 0.05)
            p.copy_(torch.randn(p.shape, generator=gen) * scale + (1.0 if name == "norm.weight" else 0.0))
    quantize_stacked_convnext([block])
    return block.to(device)


def wide_input(b, t, c, seed):
    """bf16 activations over six decades, with exact zeros and negative zeros among them."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, c, generator=gen) * 10.0 ** (torch.rand(b, t, c, generator=gen) * 6 - 3)
    x[:, ::7, ::5] = 0.0
    x[:, 3::7, ::5] = -0.0
    return x.to(torch.bfloat16)


def parent_block(block, x, mask, impl):
    """The block's int8 / fused forward as written before the fold: the plain chain."""
    residual = x
    if mask is not None:
        x = x * mask
    x = depthwise_conv1d_shifts(x, block.dwconv.weight[:, 0, :].t(), block.dwconv.bias, padding=3)
    b, t, c = x.shape
    xf, rf = x.reshape(b * t, c), residual.reshape(b * t, c)
    if impl == "int8":
        return fc.fused_ln_ffn_int8(xf, rf, block.norm.weight, block.norm.bias, block.pw1_q, block.pw1_s,
                                    block.pwconv1.bias, block.pw2_q, block.pw2_s, block.pwconv2.bias, block.gamma,
                                    eps=1e-6).reshape(b, t, c)
    return fc.fused_convnext_ffn(xf, rf, block).reshape(b, t, c)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16)


def round_once(v: torch.Tensor) -> torch.Tensor:
    """float64 values (normal, exactly held) rounded once to bf16's 8-bit
    significand, to nearest even, as a bf16 instruction rounds its exact result."""
    m, e = torch.frexp(v)
    return torch.ldexp(torch.round(m * 256.0) / 256.0, e)


def folded_xdw(x, block, bound: int) -> torch.Tensor:
    """The rows pass's conv, tile by tile as a block of ``csrc/dw_rows.cuh``
    forms it (BF16_CHAIN): a window of rows t0 - 3 .. t0 + ROWS + 2 of one
    item, rows outside [0, T) zero, rows at or past the bound reduced to their
    sign bits; each tap product and running sum one bf16 instruction (its
    exact result rounded once), taps 0..6 in order, the bias last."""
    b, t, c = x.shape
    w, bias = (z.to(torch.float64) for z in fc._dw_taps(block, torch.bfloat16))
    out = torch.empty(b, t, c, dtype=torch.bfloat16)
    for item in range(b):
        for t0 in range(0, t, ROWS):
            win = torch.zeros(ROWS + 2 * HALO, c, dtype=torch.int16)
            for r in range(ROWS + 2 * HALO):
                tt = t0 - HALO + r
                if 0 <= tt < t:
                    row = bits(x[item, tt])
                    win[r] = row if tt < bound else row & torch.tensor(-0x8000, dtype=torch.int16)
            win = win.view(torch.bfloat16).to(torch.float64)
            for r in range(min(ROWS, t - t0)):
                acc = round_once(win[r] * w[0])
                for k in range(1, 7):
                    acc = round_once(acc + round_once(win[r + k] * w[k]))
                out[item, t0 + r] = round_once(acc + bias).to(torch.bfloat16)
    return out


FRAME_VALIDS = [None, 45, 20, 0, 60, "tensor"]


@pytest.mark.parametrize("impl", ["int8", "fused"])
@pytest.mark.parametrize("frame_valid", FRAME_VALIDS)
def test_block_on_the_cpu_is_the_plain_chain(impl, frame_valid):
    """The int8 and fused blocks on the CPU equal the chain as it was written
    before the fold, bit for bit: T = 45 (a tile of 32 and a ragged one),
    B = 2, the width None, an int (inside T, 0, past T) or a 0-d tensor."""
    b, t, c = 2, 45, 64
    block = random_block(c, 128, seed=3)
    x = wide_input(b, t, c, seed=4)
    fv = torch.tensor(20) if frame_valid == "tensor" else frame_valid
    mask = edge_mask(t, fv, x.dtype, x.device)
    with torch.no_grad():
        got = block(x, mask, impl, fv)
        want = parent_block(block, x, mask, impl)
    assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("b,t", [(2, 45), (2, 5), (3, 64), (1, 1)])
@pytest.mark.parametrize("bound", [0, 1, 20, 45, 64])
def test_folded_conv_rounds_as_the_plain_chain(b, t, bound):
    """The rows pass's conv (window, edge, one rounding a product or sum)
    equals the edge-mask multiply and ``depthwise_conv1d_shifts`` (PyTorch
    rounds each bf16 result to f32, then to bf16) bit for bit, signed zeros
    included: T a multiple of the tile, ragged, shorter than the window and
    1; B > 1, so that halos meet at an item boundary; the bound at 0, inside
    T and past it."""
    c = 64
    block = random_block(c, 128, seed=5)
    x = wide_input(b, t, c, seed=6)
    mask = (torch.arange(t) < bound).to(x.dtype)[None, :, None]
    with torch.no_grad():
        want = depthwise_conv1d_shifts(x * mask, block.dwconv.weight[:, 0, :].t(), block.dwconv.bias, padding=3)
        got = folded_xdw(x, block, min(bound, t))
    assert torch.equal(bits(got), bits(want))


def test_bf16_sums_and_products_round_once_as_pytorch_rounds_them():
    """PyTorch forms a bf16 sum or product in f32 and rounds that to bf16;
    the kernel's bf16x2 instructions round the exact result once.  For bf16
    operands the two agree (the product is exact in f32; a sum rounded to 24
    bits, then to 8, is the sum rounded to 8): checked on operands whose
    exponents lie up to 40 binades apart, ties and near-ties among them."""
    gen = torch.Generator().manual_seed(12)
    n = 200_000
    a = (torch.randn(n, generator=gen) * 2.0 ** torch.randint(-20, 21, (n,), generator=gen)).to(torch.bfloat16)
    b = (torch.randn(n, generator=gen) * 2.0 ** torch.randint(-20, 21, (n,), generator=gen)).to(torch.bfloat16)
    tie = a.to(torch.float64) * (1 + 2.0 ** -8)  # a's half-ulp: sums near ties
    b[: n // 4] = (tie[: n // 4] - a[: n // 4].to(torch.float64)).to(torch.bfloat16)
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    nonzero = (a64 + b64) != 0
    assert torch.equal(bits((a + b)[nonzero]), bits(round_once(a64 + b64).to(torch.bfloat16)[nonzero]))
    assert torch.equal(bits(a * b), bits(round_once(a64 * b64).to(torch.bfloat16)))


class Launches:
    """``_cuda.launch`` recorded instead of run, on a stream-less device."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(_cuda, "stream", lambda device: ctypes.c_void_p(0))
        monkeypatch.setattr(_cuda, "launch", lambda lib, fn, key, *args: self.calls.append((lib, fn, key, args)))


def no_plain_conv(*args, **kwargs):
    raise AssertionError("the plain depthwise conv ran on the kernels' path")


@pytest.mark.parametrize("impl,lib,fn,key", [("int8", "ln_ffn_int8", "ln_ffn_int8_dw", "ln_ffn_int8:512x4096"),
                                             ("fused", "ln_ffn", "ln_ffn_bf16_dw", "ln_ffn_bf16:512x4096")])
def test_a_block_off_the_cpu_launches_one_folded_call(monkeypatch, impl, lib, fn, key):
    """A Vocos block off the CPU launches its chain once, through the folded
    entry point and under the unfolded kernel's launch key (one count a
    block), with the conv's taps, bias, edge, B and T after the unfolded
    arguments; it runs no plain conv.  A transformer FFN still launches the
    unfolded entry point."""
    launches = Launches(monkeypatch)
    monkeypatch.setattr(vmod, "depthwise_conv1d_shifts", no_plain_conv)
    block = random_block(512, 4096, seed=7, device="meta")
    x = torch.empty(2, 45, 512, dtype=torch.bfloat16, device="meta")
    bound = torch.empty(1, dtype=torch.int32, device="meta")
    out = block(x, None, impl, 40, bound)
    assert out.shape == x.shape and out.dtype == x.dtype
    ((got_lib, got_fn, got_key, args),) = launches.calls
    assert (got_lib, got_fn, got_key) == (lib, fn, key)
    assert [a.value for a in args[-4:-2]] == [2, 45]  # B, T, then passes and the stream
    assert args[-2].value == sum(fc._FFN[fc.FOLDED_KINDS[impl]][4].values())

    launches.calls.clear()
    layer = tmod.TransformerLayer(768, 12, 3072)
    quantize_stacked_ffn([layer])
    layer = layer.to("meta")
    xt = torch.empty(3 * 50, 768, dtype=torch.bfloat16, device="meta")
    ln = layer.final_layer_norm
    if impl == "int8":
        fc.fused_ln_ffn_int8(xt, xt, ln.weight, ln.bias, layer.fc1_q, layer.fc1_s, layer.fc1.bias, layer.fc2_q,
                             layer.fc2_s, layer.fc2.bias, eps=1e-5)
    else:
        fc.fused_ln_ffn(xt, xt, ln.weight, ln.bias, layer.fc1.weight, layer.fc1.bias, layer.fc2.weight, layer.fc2.bias,
                        eps=1e-5)
    ((got_lib, got_fn, got_key, _),) = launches.calls
    assert (got_lib, got_fn, got_key) == (lib, fn[:-len("_dw")], key.replace("512x4096", "768x3072"))


@pytest.mark.parametrize("impl", ["int8", "fused"])
def test_a_vocos_forward_makes_its_edge_bound_once(monkeypatch, impl):
    """``frame_bound`` runs once a Vocos forward, not once a block; each of
    the blocks launches its folded chain."""
    launches = Launches(monkeypatch)
    made = []
    real = fc.frame_bound
    monkeypatch.setattr(fc, "frame_bound", lambda *a: made.append(real(*a)) or made[-1])
    monkeypatch.setattr(vmod, "istft_same", lambda consts, re, im, fv: torch.empty(re.shape[0], 1, device=re.device))
    cfg = VocosConfig(input_channels=8, dim=64, intermediate_dim=128, num_layers=3, n_fft=16, hop_size=4)
    model = Vocos(cfg)
    quantize_stacked_convnext(model.backbone.convnext)
    model = model.to(torch.bfloat16).to("meta")
    mel = torch.empty(2, 30, 8, dtype=torch.bfloat16, device="meta")
    model(mel, torch.empty(2, dtype=torch.int64, device="meta"), torch.empty((), dtype=torch.int64, device="meta"),
          impl)
    key = fc._FFN[fc.FOLDED_KINDS[impl]][2]
    assert len(made) == 1 and [k for _, _, k, _ in launches.calls] == [f"{key}:64x128"] * 3


def test_folded_arguments_follow_the_unfolded_kinds():
    """The folded kinds hand the unfolded entry point's tensors at the same
    places (output and workspaces included), then the taps (7, C), the bias
    and the edge; they refuse an edge that is not one device int32."""
    block = random_block(256, 512, seed=8, device="meta")
    x = torch.empty(3, 70, 256, dtype=torch.bfloat16, device="meta")
    bound = torch.empty(1, dtype=torch.int32, device="meta")
    for impl, unfolded in (("int8", "int8"), ("fused", "bf16")):
        kind = fc.FOLDED_KINDS[impl]
        lib, fn, key, build, passes, out_index = fc._FFN[kind]
        assert (lib, key, passes, out_index) == (fc._FFN[unfolded][0], fc._FFN[unfolded][2], fc._FFN[unfolded][4],
                                                 fc._FFN[unfolded][5])
        args, tensors, shape = build(x, block, bound)
        assert shape == "256x512"
        assert [tuple(t.shape) for t in tensors[-3:]] == [(7, 256), (256,), (1,)]
        assert tensors[0].shape == tensors[1].shape == tensors[out_index].shape == (210, 256)
        assert [a.value for a in args[-2:]] == [3, 70]
        for bad in (torch.empty(1, dtype=torch.int64, device="meta"), torch.empty(2, dtype=torch.int32, device="meta"),
                    7):
            with pytest.raises(ValueError):
                build(x, block, bad)


def test_the_fold_refuses_the_cpu_and_other_impls():
    """No fallback: the folded wrapper launches or raises."""
    block = random_block(64, 128, seed=9)
    x = torch.zeros(1, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fc.fused_convnext_block(x, block, "int8", fc.frame_bound(None, 8, x.device))
    with pytest.raises(ValueError):
        fc.fused_convnext_block(x.to("meta"), block.to("meta"), "fused-dw", torch.empty(1, dtype=torch.int32,
                                                                                          device="meta"))


KERNEL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
PASS_KERNEL = re.compile(r"^FFN_PASS_KERNEL\((\w+),", re.M)


@pytest.mark.parametrize("source,group", [("ln_ffn.cu", "B2"), ("ln_ffn_int8.cu", "B3")])
def test_kernel_names_match_the_yardstick_groups(source, group):
    """Every row and pass kernel of B2 and B3 (but the partial down passes,
    which no cell runs) carries a name fragment of its group in
    ``benchmark/yardstick.KERNEL_GROUPS``, so the rooflines read the folded
    rows pass as the one it replaces; each source has one row kernel, whose
    template holds both the plain and the folded instantiation."""
    from benchmark import yardstick

    text = (_cuda.CSRC_DIR / source).read_text()
    rows = KERNEL.findall(text)
    passes = PASS_KERNEL.findall(text)
    assert len(rows) == 1 and rows[0].endswith("_rows_kernel") and len(passes) >= 3
    assert re.search(r"template <int NT, bool DW>\s*__global__", text)
    for name in rows + [p for p in passes if not p.endswith("_partial_kernel")]:
        assert f"::{name}<" in yardstick.KERNEL_GROUPS[group], name


@pytest.mark.chip
@pytest.mark.parametrize("b", [16, 8])
def test_on_the_card_the_fold_is_the_plain_chain(b):
    """At the Vocos shape (B x 3000 x 512, I 4096) with the edge at T, 1731, 1
    and 0: the folded rows pass's xq / xs / hmax (B3) and xn (B2) equal the
    plain conv followed by the unfolded rows pass, and the blocks' outputs
    equal the plain chain's, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda", torch.cuda.current_device())
    t, c, inter = 3000, 512, 4096
    block = random_block(c, inter, seed=10, device=dev)
    x = wide_input(b, t, c, seed=11).to(dev)
    workspaces = {"int8": (12, 13, 14), "fused": (10,)}
    with torch.no_grad():
        for fv in (t, 1731, 1, 0):
            bound = fc.frame_bound(torch.tensor(fv, device=dev), t, dev)
            mask = edge_mask(t, torch.tensor(fv, device=dev), x.dtype, dev)
            xdw = depthwise_conv1d_shifts(x * mask, block.dwconv.weight[:, 0, :].t(), block.dwconv.bias, padding=3)
            for impl, unfolded in (("int8", "int8"), ("fused", "bf16")):
                rows = xdw.reshape(-1, c), x.reshape(-1, c), block.norm.weight, block.norm.bias
                weights = ((block.pw1_q, block.pw1_s, block.pwconv1.bias, block.pw2_q, block.pw2_s, block.pwconv2.bias)
                           if impl == "int8" else
                           (block.pwconv1.weight, block.pwconv1.bias, block.pwconv2.weight, block.pwconv2.bias))
                plain_run, plain = fc.ffn_passes(unfolded, *rows, *weights, block.gamma, 1e-6)
                fold_run, fold = fc.ffn_passes(fc.FOLDED_KINDS[impl], x, block, bound)
                plain_run["rows"]()
                fold_run["rows"]()
                torch.cuda.synchronize()
                for i in workspaces[impl]:
                    assert torch.equal(plain[i].view(torch.uint8), fold[i].view(torch.uint8)), (impl, fv, i)
                want = parent_block(block, x, mask, impl)
                got = block(x, mask, impl, torch.tensor(fv, device=dev))
                assert torch.equal(bits(got), bits(want)), (impl, fv)
