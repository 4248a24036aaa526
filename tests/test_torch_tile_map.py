"""Host-side geometry of the attention kernels' TMA tensor maps.

``ops/flash_attention.py::tile_map`` computes, for each operand of the B1
and B5 kernels (bf16, and the f32 kernels of ``csrc/attn_f32.cu``), the
dims, byte strides, box and swizzle that the C entry points encode into
``CUtensorMap``s.  The kernels themselves run only on the GPU
(``chip_smoke.py``); what they are handed is checked here, for every
supported head dim and both dtypes, on the two layouts the codec gives them.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from simwhisper_codec_tpu_torch.ops import flash_attention as tfa

BF16 = torch.bfloat16
F32 = torch.float32


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


def test_profile_groups_name_the_f32_kernels():
    """The f32 instantiations of B1 and B5 have groups of their own, matched
    by their traced names and by their wrappers' launch-count keys, and no
    hand kernel's name holds "gemm"."""
    prof = _profile_tool()
    names = [
        ("B1 pflash f32",
         "void (anonymous namespace)::pflash_f32_kernel<64>(CUtensorMap_st, int const*, float*, int, int)"),
        ("B5 flash f32", "void (anonymous namespace)::flash_f32_kernel<128>(CUtensorMap_st, CUtensorMap_st, "
                         "CUtensorMap_st, int const*, float*, int, (anonymous namespace)::Strides)"),
    ]
    for group, name in names:
        assert [g for g, frags in prof.GROUPS.items() if any(f in name for f in frags)] == [group], name
    keys = {tfa.PFLASH_KERNELS[F32][2]: 24, tfa.FLASH_KERNELS[F32][2]: 24}
    assert keys == {"pflash_attention_f32": 24, "flash_attention_f32": 24}
    assert prof.unmatched_groups(keys, {"B1 pflash f32": 30.0}) == ["B5 flash f32"]
    assert prof.unmatched_groups(keys, {"B1 pflash f32": 30.0, "B5 flash f32": 40.0}) == []
    assert {"parity-pflash", "parity-flash"} <= set(prof.CONFIGS)
    source = (tfa._cuda.CSRC_DIR / "attn_f32.cu").read_text()
    assert "pflash_f32_kernel" in source and "flash_f32_kernel" in source and "gemm" not in source.lower()


@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
def test_tile_map_f32(hd):
    """f32 operands: a box row is at most 128 bytes, so 32 columns; hd = 64
    takes two boxes and hd = 128 four, each swizzled 128 B (hd = 16: one
    64-byte box), on both the packed (B, T, 3D) and the (B, H, T, hd) layouts."""
    b, t, heads = 2, 203, 3
    d = heads * hd
    cols = min(hd, 32)
    g = tfa.tile_map(torch.empty(b, t, 3 * d, dtype=F32), hd)
    assert g.dims == (3 * d, t, b)
    assert g.strides == (3 * d * 4, t * 3 * d * 4)
    assert g.box == (cols, 64, 1) and g.swizzle == cols * 4 == {16: 64, 32: 128, 64: 128, 128: 128}[hd]
    assert hd % cols == 0 and d % cols == 0  # q, k and v of every head start on a box
    assert list(g.as_c()) == [3, 3 * d, t, b, 0, 0, 3 * d * 4, t * 3 * d * 4, 0, 0, cols, 64, 1, 0, 0, cols * 4]
    packed = torch.empty(b, t, 3, heads, hd, dtype=F32)
    for x in (packed[:, :, 1].transpose(1, 2), torch.empty(b, t, heads, hd, dtype=F32).transpose(1, 2)):
        g = tfa.tile_map(x, hd)
        assert g.dims == (hd, t, heads, b)
        assert g.strides == tuple(s * 4 for s in (x.stride(2), x.stride(1), x.stride(0)))
        assert g.box == (cols, 64, 1, 1) and g.swizzle == cols * 4
    # the B5 output is written by stride: multiples of 4 floats (16 bytes)
    assert [s.value for s in tfa._strides(torch.empty(b, t, heads, hd, dtype=F32).transpose(1, 2))] == \
        [t * heads * hd, hd, heads * hd]


def test_tile_map_refuses_other_dtypes():
    with pytest.raises(ValueError, match="bf16 or f32"):
        tfa.tile_map(torch.empty(2, 64, 3 * 64, dtype=torch.float16), 16)
    f32_odd = torch.empty(2, 40, 3 * 4 * 16 + 1, dtype=F32)[..., 1:]  # base 4 bytes off 16
    with pytest.raises(ValueError):
        tfa.tile_map(f32_odd, 16)
