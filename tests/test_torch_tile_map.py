"""Host-side geometry of the attention kernels' TMA tensor maps.

``ops/flash_attention.py::tile_map`` computes, for each operand of the B1
and B5 kernels, the dims, byte strides, box and swizzle that the C entry
points encode into ``CUtensorMap``s.  The kernels themselves run only on the
GPU (``chip_smoke.py``); what they are handed is checked here, for every
supported head dim, on the two layouts the codec gives them.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from simwhisper_codec_tpu_torch.ops import flash_attention as tfa

BF16 = torch.bfloat16


def _profile_tool():
    path = Path(__file__).resolve().parent.parent / "tools" / "profile_torch_port.py"
    spec = importlib.util.spec_from_file_location("profile_torch_port", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
def test_tile_map_packed_qkv(hd):
    """(B, T, 3D) packed QKV: one 3-D map (3D, T, B); q, k and v of head h are
    boxes at columns h*hd, D + h*hd and 2D + h*hd of it."""
    b, t, heads = 2, 203, 3
    d = heads * hd
    qkv = torch.empty(b, t, 3 * d, dtype=BF16)
    g = tfa.tile_map(qkv, hd)
    cols = min(hd, 64)
    assert g.dims == (3 * d, t, b)
    assert g.strides == (3 * d * 2, t * 3 * d * 2)
    assert g.box == (cols, 64, 1)
    assert g.swizzle == cols * 2 == {16: 32, 32: 64, 64: 128, 128: 128}[hd]
    assert hd % cols == 0 and (2 * d) % cols == 0  # every head's columns start on a box
    assert list(g.as_c()) == [3, 3 * d, t, b, 0, 0, 3 * d * 2, t * 3 * d * 2, 0, 0, cols, 64, 1, 0, 0, cols * 2]


@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
def test_tile_map_head_views(hd):
    """The strided (B, H, T, hd) views that varlen_attention_flash hands to B5:
    q contiguous (B, T, H, hd) transposed, k and v slices of the packed
    (B, T, 3, H, hd) product; 4-D maps (hd, T, H, B) by stride."""
    b, t, heads = 2, 150, 4
    qkv = torch.empty(b, t, 3, heads, hd, dtype=BF16)
    q = torch.empty(b, t, heads, hd, dtype=BF16).transpose(1, 2)
    k, v = qkv[:, :, 1].transpose(1, 2), qkv[:, :, 2].transpose(1, 2)
    cols = min(hd, 64)
    gq = tfa.tile_map(q, hd)
    assert gq.dims == (hd, t, heads, b)
    assert gq.strides == (heads * hd * 2, hd * 2, t * heads * hd * 2)
    for x in (k, v):
        g = tfa.tile_map(x, hd)
        assert g.dims == (hd, t, heads, b)
        assert g.strides == (3 * heads * hd * 2, hd * 2, t * 3 * heads * hd * 2)
        assert g.box == (cols, 64, 1, 1) and g.swizzle == cols * 2
    assert len(gq.as_c()) == 16 and gq.as_c()[0] == 4


@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
def test_tile_map_refuses_misaligned(hd):
    """A byte stride that is not a multiple of 16, a base off 16 bytes or a
    last dim that is not contiguous cannot be a TMA map: ValueError."""
    padded = torch.empty(1, 2, 40, hd + 4, dtype=BF16)[..., :hd]  # time stride (hd + 4) * 2 bytes
    with pytest.raises(ValueError):
        tfa.tile_map(padded, hd)
    with pytest.raises(ValueError):
        tfa.tile_map(torch.empty(2, 40, 3 * 2 * hd + 8, dtype=BF16)[..., 1:], hd)  # base + 2 bytes
    with pytest.raises(ValueError):
        tfa.tile_map(torch.empty(1, 2, hd, 40, dtype=BF16).transpose(-1, -2), hd)


def test_profile_groups_name_the_kernels():
    """Each hand kernel's traced name falls in its own group and no other, and
    a launched kernel that no group matches is reported."""
    prof = _profile_tool()
    gemm_args = "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, ffn_sm90::Shape, {})"
    names = [
        ("B1 pflash", "void (anonymous namespace)::pflash_sm90_kernel<64>(CUtensorMap_st, int const*, __nv_bfloat16*, int, int)"),
        ("B2 ln_ffn", "void (anonymous namespace)::ln_ffn_bf16_rows_kernel<12>(__nv_bfloat16 const*, float)"),
        ("B2 ln_ffn", "void (anonymous namespace)::ln_ffn_bf16_up_kernel<128>" + gemm_args.format("ffn_bf16::UpEpilogue")),
        ("B2 ln_ffn", "void (anonymous namespace)::ln_ffn_bf16_down_kernel<192>" + gemm_args.format("ffn_bf16::DownEpilogue")),
        ("B3 ln_ffn_int8", "void (anonymous namespace)::ln_ffn_int8_rows_kernel<8>(__nv_bfloat16 const*, float)"),
        ("B3 ln_ffn_int8", "void (anonymous namespace)::ln_ffn_int8_upmax_kernel<128>"
         + gemm_args.format("(anonymous namespace)::UpMaxEpilogue")),
        ("B3 ln_ffn_int8", "void (anonymous namespace)::ln_ffn_int8_upq_kernel<128>"
         + gemm_args.format("(anonymous namespace)::UpQuantEpilogue")),
        ("B3 ln_ffn_int8", "void (anonymous namespace)::ln_ffn_int8_down_kernel<256>"
         + gemm_args.format("(anonymous namespace)::DownEpilogue")),
        # B4 runs B2's passes under its own names
        ("B4 convnext_dw", "void (anonymous namespace)::convnext_dw_rows_kernel<8>(__nv_bfloat16 const*, int, float)"),
        ("B4 convnext_dw", "void (anonymous namespace)::convnext_dw_up_kernel<128>" + gemm_args.format("ffn_bf16::UpEpilogue")),
        ("B4 convnext_dw", "void (anonymous namespace)::convnext_dw_down_kernel<256>"
         + gemm_args.format("ffn_bf16::DownEpilogue")),
        ("B5 flash", "void (anonymous namespace)::flash_sm90_kernel<64>(CUtensorMap_st, CUtensorMap_st)"),
        ("GEMMs", "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1"),
        ("GEMMs", "nvjet_tst_192x192_64x4_2x1_v_bz_coopB_TNN"),
    ]
    for group, name in names:
        hits = [g for g, frags in prof.GROUPS.items() if any(f in name for f in frags)]
        assert hits == [group], (name, hits)
    launches = {"pflash_attention": 2, "ln_ffn_bf16:768x3072": 2, "flash_attention": 0}
    assert prof.unmatched_groups(launches, {"B1 pflash": 1.5, "B2 ln_ffn": 0.0}) == ["B2 ln_ffn"]
    assert prof.unmatched_groups(launches, {"B1 pflash": 1.5, "B2 ln_ffn": 2.0}) == []
    assert prof.unmatched_groups({"convnext_dw:512x4096": 24}, {"B2 ln_ffn": 11.0}) == ["B4 convnext_dw"]
