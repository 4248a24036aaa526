"""Host-side geometry of the B4 passes (``fused_convnext_block_dw``).

B4 runs as three passes: its own row kernel (masked depthwise k7 + LN ->
xn over the B*T rows), then B2's up and down passes on the workspaces.
``ops/fused_convnext.py::_convnext_dw_args`` builds the C entry point's
argument list: the operands, the workspaces and the four TMA tensor maps.
The kernels run only on the GPU (``chip_smoke.py``); what they are handed is
checked here on the ``meta`` device, where no tensor has storage and no
CUDA pointer is needed (the down width is balanced over the H100's SMs).
"""

import ctypes

import pytest
import torch

from simwhisper_codec_tpu_torch.models.vocos import ConvNeXtBlock
from simwhisper_codec_tpu_torch.ops import fused_convnext as fc

SHAPES = [(8, 3000, 512, 4096), (3, 203, 256, 192)]  # the Vocos shape; ragged T at B = 3


def _args(b, t, c, inter, frame_valid=None, device="meta"):
    block = ConvNeXtBlock(c, inter, 0.1).to(device)
    x = torch.empty(b, t, c, dtype=torch.bfloat16, device=device)
    return fc._convnext_dw_args(x, block, frame_valid, 1e-6)


@pytest.mark.parametrize("b,t,c,inter", SHAPES)
def test_dw_workspaces_and_operands(b, t, c, inter):
    """The operands in the C entry point's order (x, dw_w (7, C), five C-vectors
    and b1, W1 (I, C), W2 (C, I), out (B, T, C)) and the bf16 workspaces
    xn (B T, C) and h (B T, I); the scalars B, T, C, I, then frame_valid as
    a pointer to a device int32 (the last tensor), then eps."""
    args, tensors, shape = _args(b, t, c, inter, frame_valid=t - 7)
    assert shape == f"{c}x{inter}"
    want = [(b, t, c), (7, c), (c,), (c,), (c,), (inter, c), (inter,), (c, inter), (c,), (c,), (b, t, c),
            (b * t, c), (b * t, inter), (1,)]
    assert [tuple(v.shape) for v in tensors] == want
    assert all(v.dtype == torch.bfloat16 and v.is_contiguous() for v in tensors[:-1])
    assert tensors[-1].dtype == torch.int32
    assert len(args) == 13 + 6 + 4
    assert [a.value for a in args[13:17]] == [b, t, c, inter] and isinstance(args[17], ctypes.c_void_p)


@pytest.mark.parametrize("b,t,c,inter", SHAPES)
def test_dw_tile_maps(b, t, c, inter):
    """The four maps of B2's passes over B*T rows: xn (C, B T) and W1 (C, I)
    for the up pass, h (I, B T) and W2 (I, C) for the down pass; 128-byte K
    slices swizzled 128 B, activation boxes of 128 rows, W1 boxes of the up
    width, W2 boxes of the down width ``block_n(B T, C)``."""
    m = b * t
    args, _, _ = _args(b, t, c, inter)
    up_a, up_b, down_a, down_b = (list(g) for g in args[19:])
    for g, (k, rows, box_rows) in ((up_a, (c, m, fc.ROW_TILE)), (up_b, (c, inter, fc.UP_BLOCK_N)),
                                   (down_a, (inter, m, fc.ROW_TILE)), (down_b, (inter, c, fc.block_n(m, c)))):
        assert g == [2, k, rows, 0, 0, 0, 2 * k, 0, 0, 0, 64, box_rows, 0, 0, 0, 128]


def test_dw_down_width_and_passes():
    """At 8 x 3000 rows the 512-wide down pass takes 256-wide blocks (as B2's
    at the same shape); at 609 rows every width fills one wave of the SMs,
    so the narrowest, 128.  The three pass bits (rows, up, down) sum to 7,
    and the "dw" entry runs B2's bits under B4's launch-count key."""
    assert fc.block_n(8 * 3000, 512) == 256 and fc.block_n(3 * 203, 256) == 128
    lib, fn, key, build, passes, out_index = fc._FFN["dw"]
    assert (lib, fn, key, build, out_index) == ("convnext_dw", "convnext_dw_bf16", "convnext_dw", fc._convnext_dw_args,
                                                10)
    assert passes == fc.BF16_PASSES == {"rows": 1, "up": 2, "down": 4} and sum(passes.values()) == 7


@pytest.mark.parametrize("b,t,frame_valid,want", [(2, 5, 0, 0), (2, 5, 9, 5), (1, 1, None, 1), (3, 203, 150, 150)])
def test_dw_frame_valid_is_clipped_to_t(b, t, frame_valid, want):
    """frame_valid = None means T, and a bound past T is T: the row kernel
    reads rows [0, min(frame_valid, T)) of each item, from the device int32
    it is handed (planned on the CPU here, where the bound has a value); a
    width given as a tensor is clipped the same way, on its device."""
    _, tensors, _ = _args(b, t, 64, 128, frame_valid=frame_valid, device="cpu")
    assert int(tensors[-1]) == want
    if frame_valid is not None:
        _, tensors, _ = _args(b, t, 64, 128, frame_valid=torch.tensor(frame_valid), device="cpu")
        assert tensors[-1].dtype == torch.int32 and int(tensors[-1]) == want


@pytest.mark.parametrize("c,inter,frame_valid", [(832, 128, None), (512, 48, None), (512, 128, -1), (96, 128, None)])
def test_dw_refuses_what_the_kernels_do_not_take(c, inter, frame_valid):
    """C past 768 or not a multiple of 64, I not a multiple of 32 and a
    negative frame_valid raise ValueError before anything is launched."""
    with pytest.raises(ValueError):
        _args(2, 40, c, inter, frame_valid=frame_valid)


def test_dw_refuses_other_dtypes_and_ranks():
    block = ConvNeXtBlock(64, 128, 0.1).to("meta")
    with pytest.raises(ValueError):
        fc._convnext_dw_args(torch.empty(2, 40, 64, device="meta"), block)  # float32
    with pytest.raises(ValueError):
        fc._convnext_dw_args(torch.empty(80, 64, dtype=torch.bfloat16, device="meta"), block)


def test_dw_makes_a_transposed_input_contiguous():
    """The first Vocos block's input is a transposed view of the embedding
    conv's output: the kernel gets a contiguous copy (and its residual is
    that copy, not the view)."""
    block = ConvNeXtBlock(64, 128, 0.1).to("meta")
    x = torch.empty(2, 64, 40, dtype=torch.bfloat16, device="meta").transpose(1, 2)
    _, tensors, _ = fc._convnext_dw_args(x, block)
    assert tensors[0].shape == (2, 40, 64) and tensors[0].is_contiguous()
    assert tensors[10].shape == (2, 40, 64) and tensors[10].is_contiguous()
