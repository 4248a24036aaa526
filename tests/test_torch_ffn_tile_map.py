"""Host-side geometry of the B2 and B3 passes' TMA tensor maps and workspaces.

``ops/fused_convnext.py`` allocates the intermediates of the passes (a row
kernel, then up- and down-projection GEMMs on ``csrc/ffn_sm90.cuh``) and
computes, for every GEMM operand, the dims, byte strides, box and swizzle
that the C entry points encode into ``CUtensorMap``s.  The kernels run only
on the GPU (``chip_smoke.py``); what they are handed is checked here for
every accepted (C, I), both dtypes, and ragged row counts.
"""

import pytest
import torch

from simwhisper_codec_tpu_torch.ops import fused_convnext as fc

WIDTHS = range(64, 769, 64)
INTERS = {"bf16": range(32, 4097, 32), "int8": range(64, 4097, 64)}
DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}


def _maps(m, c, inter, kind, device="meta"):
    dt = DTYPES[kind]
    ws = fc.ffn_workspaces(m, c, inter, kind == "int8", device)
    a_up, a_down = (ws["xq"], ws["hq"]) if kind == "int8" else (ws["xn"], ws["h"])
    w1 = torch.empty(inter, c, dtype=dt, device=device)
    w2 = torch.empty(c, inter, dtype=dt, device=device)
    return ws, fc.ffn_tile_maps(a_up, w1, a_down, w2)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("c", WIDTHS)
def test_pass_geometry_every_accepted_shape(c, kind):
    """For every I the kernels accept at this C: the workspaces' shapes and
    dtypes, and the four operand maps (xn/xq and W1 of the up pass, h/hq and
    W2 of the down pass): 2-D (K, rows), 128-byte K slices swizzled 128 B,
    activation boxes of 128 rows, weight boxes of one of the kernels' widths."""
    m = 12000
    item = 2 if kind == "bf16" else 1
    for inter in INTERS[kind]:
        ws, (up_a, up_b, down_a, down_b) = _maps(m, c, inter, kind)
        if kind == "bf16":
            assert {k: (tuple(v.shape), v.dtype) for k, v in ws.items()} == {
                "xn": ((m, c), torch.bfloat16), "h": ((m, inter), torch.bfloat16)}
        else:
            assert {k: (tuple(v.shape), v.dtype) for k, v in ws.items()} == {
                "xq": ((m, c), torch.int8), "xs": ((m,), torch.float32), "hmax": ((m,), torch.int32),
                "hq": ((m, inter), torch.int8)}
        for g, (k, rows) in ((up_a, (c, m)), (up_b, (c, inter)), (down_a, (inter, m)), (down_b, (inter, c))):
            assert g.dims == (k, rows) and g.strides == (k * item,)
            assert g.box[0] * item == fc.K_SLICE_BYTES == g.swizzle == 128
        assert up_a.box[1] == down_a.box[1] == fc.ROW_TILE == 128
        assert up_b.box[1] == fc.UP_BLOCK_N == 128 and down_b.box[1] == fc.block_n(m, c) in fc.BLOCK_NS
        assert list(down_b.as_c()) == [2, inter, c, 0, 0, 0, inter * item, 0, 0, 0,
                                       128 // item, down_b.box[1], 0, 0, 0, 128]


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_pass_maps_refuse_misaligned(kind):
    """A row stride that is not a multiple of 16 bytes, a base off 16 bytes
    or a K dim that is not contiguous cannot be a TMA map: ValueError."""
    dt = DTYPES[kind]
    c, rows = 256, 40
    with pytest.raises(ValueError):
        fc.operand_map(torch.empty(rows, c + 4, dtype=dt)[:, :c], 128)  # row stride 8 bytes off
    with pytest.raises(ValueError):
        fc.operand_map(torch.empty(rows * c + 16, dtype=dt)[1:1 + rows * c].view(rows, c), 128)  # base off
    with pytest.raises(ValueError):
        fc.operand_map(torch.empty(c, rows * 16, dtype=dt).t(), 128)  # K strided
    with pytest.raises(ValueError):
        fc.operand_map(torch.empty(rows, c, dtype=torch.float32), 128)  # neither bf16 nor int8
    fc.operand_map(torch.empty(rows, c + 16, dtype=dt)[:, :c], 128)  # padded rows are fine


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("m", [1, 127, 128, 301])
def test_pass_maps_ragged_rows(m, kind):
    """Any M >= 1: the activation maps cover exactly M rows (the TMA reads rows
    past M as zeros, the epilogues clip the stores), in ceil(M / 128) tiles,
    and the block widths still balance the tiles over the SMs."""
    c, inter = 256, 192
    ws, (up_a, up_b, down_a, down_b) = _maps(m, c, inter, kind, device="cpu")
    assert up_a.dims == (c, m) and down_a.dims == (inter, m)
    assert all(v.shape[0] == m for v in ws.values())
    assert up_b.box[1] == fc.UP_BLOCK_N
    bn = down_b.box[1]
    waves = lambda w: -(-(-(-m // fc.ROW_TILE) * -(-c // w)) // fc.H100_SMS)
    assert bn in fc.BLOCK_NS and all(waves(bn) * bn <= waves(w) * w for w in fc.BLOCK_NS)


def test_block_n_on_the_main_path():
    """The down passes' widths at the codec's shapes (M = 8 x 1500 transformer
    rows, 8 x 3000 Vocos rows): a 768-wide output takes 192 (2.85 waves of
    132 SMs, not 2.14 of 256), a 512-wide one 256; wide outputs take 256."""
    assert fc.block_n(12000, 3072) == 256 and fc.block_n(12000, 768) == 192
    assert fc.block_n(24000, 4096) == 256 and fc.block_n(24000, 512) == 256
    assert sum(fc.BF16_PASSES.values()) == 7 and sum(fc.INT8_PASSES.values()) == 15
