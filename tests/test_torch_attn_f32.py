"""The arithmetic and the layouts of the f32 attention kernels, on the CPU.

``csrc/attn_f32.cu`` (B1 f32 ``pflash_f32``, B5 f32 ``flash_attention_f32``)
runs only on the GPU (``chip_smoke.py``).  What its design rests on is
checked here:

- B5 f32 runs B1's one-pass online softmax and divides the output by the
  row sum at the end, where its plain version (and the JAX kernel)
  normalises the weights before the value product: in f32 the two agree
  to rounding;
- both products are a 3 x TF32 split (big = the f32 as the tensor cores
  read it as tf32, small = the rest, read as tf32 again): an emulation of
  exactly that meets the kernels' tolerance, one TF32 product does not;
- with tensor-core steps that round toward zero (a model that fits the
  drift measured on the H100), one P V accumulator over all keys drifts out
  of the tolerance and a fresh accumulator a tile does not;
- the transform warps' V^T tile, read as wgmma reads a K-major 128 B-swizzled
  B operand, hands each key position the value row that the register-A
  fragment of P puts there, and its shared-memory accesses are free of bank
  conflicts (a design check of the index arithmetic, restated here; the
  chip check of ``chip_smoke.py`` holds the kernel itself).  The block's
  shared-memory budget is a ``static_assert`` of the source.
"""

import numpy as np
import pytest
import torch

from simwhisper_codec_tpu_torch.ops import flash_attention as tfa

F32 = torch.float32
BK = 64  # keys of a tile
TF32_BITS = ~0x1FFF  # the bits of an f32 that the tensor cores read as tf32
TOL = dict(atol=1e-5, rtol=1e-5)  # the kernels' tolerance against the plain versions


def _inputs(b, t, h, hd, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, h, t, hd)).astype(np.float32)) * hd ** -0.5
    k = torch.from_numpy(rng.standard_normal((b, h, t, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, h, t, hd)).astype(np.float32))
    return q, k, v


def _excess(got, want, atol, rtol):
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def _tf32(x):
    return (x.view(torch.int32) & TF32_BITS).view(F32)


def _mm_3xtf32(a, b):
    """a @ b as three TF32 products: big = the tf32 read of an f32, small =
    x - big, read as tf32 again; big big + big small + small big."""
    ab, bb = _tf32(a), _tf32(b)
    a_s, b_s = _tf32(a - ab), _tf32(b - bb)
    return ab @ bb + ab @ b_s + a_s @ bb


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _online(q, k, v, lengths, flash, mm=torch.matmul):
    """The kernels' loop: 64-key tiles below the row's length, a running
    max and sum, O rescaled when the max grows, 1/sum at the output; B5
    adds +1.0 to every score.  Keys >= length are -inf; a length-0 row
    scores every key < T the same (the uniform weights of the f32-minimum
    fill)."""
    b, h, t, hd = q.shape
    out = torch.empty_like(q)
    for i in range(b):
        n = int(lengths[i])
        all_masked = n <= 0
        kv_end = t if all_masked else min(n, t)
        m = torch.full((h, t, 1), -float("inf"))
        l = torch.zeros(h, t, 1)
        o = torch.zeros(h, t, hd)
        for k0 in range(0, kv_end, BK):
            kt, vt = k[i, :, k0:k0 + BK], v[i, :, k0:k0 + BK]
            s = mm(q[i], kt.transpose(-1, -2))
            if flash:
                s = s + 1.0
            keys = torch.arange(k0, k0 + s.shape[-1])
            if all_masked:
                s = torch.zeros_like(s)
            s = torch.where(keys < kv_end, s, torch.tensor(-float("inf")))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            e = torch.exp(s - m_new)
            l = l * alpha + e.sum(-1, keepdim=True)
            o = o * alpha + mm(e, vt)
            m = m_new
        out[i] = o * (1.0 / l)
    return out


LENGTH_SETS = {"ragged": (203, 77, 0), "one": (1, 203, 130), "full": (203, 203, 203)}


@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
@pytest.mark.parametrize("lengths", sorted(LENGTH_SETS))
def test_deferred_normalisation_matches_flash_plain(hd, lengths):
    """B5's plain version (weights normalised, then P V) equals the one-pass
    loop that divides by the sum at the end, within 1e-6 + 1e-6 |plain| (f32
    sums in another order): lengths 0, 1, T and ragged, T = 203 (not a
    multiple of the 64-key tile)."""
    q, k, v = _inputs(3, 203, 2, hd, seed=hd)
    lens = torch.tensor(LENGTH_SETS[lengths])
    want = tfa.flash_attention_plain(q, k, v, lens)
    got = _online(q, k, v, lens, flash=True)
    assert _excess(got, want, atol=1e-6, rtol=1e-6) <= 0


@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
def test_online_loop_matches_pflash_plain(hd):
    """B1's plain version against the same loop without the key bias."""
    b, t, h = 3, 203, 2
    q, k, v = _inputs(b, t, h, hd, seed=10 + hd)
    qkv = torch.cat([x.transpose(1, 2).reshape(b, t, h * hd) for x in (q, k, v)], -1)
    lens = torch.tensor(LENGTH_SETS["ragged"])
    want = tfa.fused_qkv_attention_plain(qkv, lens, h).reshape(b, t, h, hd).transpose(1, 2)
    got = _online(q, k, v, lens, flash=False)
    assert _excess(got, want, atol=1e-6, rtol=1e-6) <= 0


@pytest.mark.parametrize("flash", [False, True], ids=["pflash", "flash"])
def test_3xtf32_split_meets_the_tolerance(flash):
    """The 3 x TF32 split of both products, emulated with the kernels'
    truncation, stays within 1e-5 + 1e-5 |plain| of the f32 plain version;
    one TF32 product does not."""
    b, t, h, hd = 3, 150, 2, 64
    q, k, v = _inputs(b, t, h, hd, seed=7)
    lens = torch.tensor((150, 77, 0))
    if flash:
        want = tfa.flash_attention_plain(q, k, v, lens)
    else:
        qkv = torch.cat([x.transpose(1, 2).reshape(b, t, h * hd) for x in (q, k, v)], -1)
        want = tfa.fused_qkv_attention_plain(qkv, lens, h).reshape(b, t, h, hd).transpose(1, 2)
    split = _online(q, k, v, lens, flash, mm=_mm_3xtf32)
    one = _online(q, k, v, lens, flash, mm=_mm_1xtf32)
    assert _excess(split, want, **TOL) <= 0
    assert float((split - want).abs().max()) < 5e-6
    assert _excess(one, want, **TOL) > 0


def _wgmma_rz(acc, a, b):
    """acc + a @ b (a: rows x 8, b: 8 x n) as one tensor-core step is modelled
    here: the exact products and the accumulator aligned to the largest
    exponent, each cut toward zero to 24 bits there, summed, and the sum
    rounded toward zero to f32."""
    terms = torch.cat([acc.double()[..., None], a.double()[:, None, :] * b.double().T[None, :, :]], -1)
    _, e = torch.frexp(terms.abs().amax(-1, keepdim=True))
    quantum = torch.ldexp(torch.ones_like(terms[..., :1]), e - 24)
    s = (torch.trunc(terms / quantum) * quantum).sum(-1)
    f = s.to(F32)
    return torch.where(f.double().abs() > s.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _pv_on_tensor_cores(p, v, per_tile):
    """P V as the kernel issues it: 64-key tiles of 8 k8 steps of three TF32
    products, into one running accumulator or (per_tile) into a fresh one a
    tile that is then added into O in f32."""
    pb, vb = _tf32(p), _tf32(v)
    ps, vs = _tf32(p - pb), _tf32(v - vb)
    o = torch.zeros(p.shape[0], v.shape[1])
    for k0 in range(0, p.shape[1], BK):
        acc = torch.zeros_like(o) if per_tile else o
        for j in range(k0, min(k0 + BK, p.shape[1]), 8):
            for x, y in ((pb, vb), (pb, vs), (ps, vb)):
                acc = _wgmma_rz(acc, x[:, j:j + 8], y[j:j + 8])
        o = o + acc if per_tile else acc
    return o


def test_per_tile_accumulator_bounds_the_drift():
    """With steps that round toward zero, a running P V accumulator over 1500
    keys of values that share an offset (as the codec's activations do)
    drifts out of 1e-5 + 1e-5 |plain|; a fresh accumulator a tile, added in
    f32, stays inside: why the kernels accumulate P V a tile at a time."""
    rng = np.random.default_rng(3)
    rows, keys, hd = 64, 1500, 16
    p = torch.from_numpy(np.exp(rng.standard_normal((rows, keys)) - 3).astype(np.float32))
    v = torch.from_numpy((2.0 + 0.1 * rng.standard_normal((keys, hd))).astype(np.float32))
    l = p.double().sum(1, keepdim=True)
    want = p.double() @ v.double() / l
    assert _excess(_pv_on_tensor_cores(p, v, per_tile=False).double() / l, want, **TOL) > 0
    assert _excess(_pv_on_tensor_cores(p, v, per_tile=True).double() / l, want, **TOL) <= 0


def test_split_is_exact():
    """big + small reproduces every f32 exactly, and small is below one
    tf32 ulp of x."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(10000).astype(np.float32))
    big = _tf32(x)
    assert torch.equal(big + (x - big), x)
    assert bool(((x - big).abs() <= x.abs() * 2.0 ** -10).all())


# ---- layouts: mirrors of the index arithmetic of csrc/attn_f32.cu ------------


def _row_offset(row, row_bytes):
    off = row * row_bytes
    return off | (((off >> 7) & (row_bytes // 16 - 1)) << 4)


def _cfg(hd):
    box_cols = min(hd, 32)
    return dict(box_cols=box_cols, row_bytes=box_cols * 4)


TRANSFORMERS = 96  # the transform threads: three warps


def _frag(r):
    """the S accumulator element of an n8 block that register a_r of the tf32 A fragment takes"""
    return 2 * (r & 1) + (r >> 1)


def _transpose_units(hd, tt):
    """The transform thread tt's V -> V^T accesses, as transpose_v makes them:
    [(reads: [(key, byte offset in the V tile)] , writes: [(row n, position, byte offset in V^T)])]."""
    c = _cfg(hd)
    units8, groups = hd // 2, TRANSFORMERS // 8
    par, gl = tt & 1, (tt >> 1) & 3
    out = []
    for p in range((units8 + groups - 1) // groups):
        u8 = (tt >> 3) + groups * p
        if u8 >= units8:
            break
        g, n0 = 4 * (u8 & 1) + gl, 4 * (u8 >> 1)
        src = (n0 // c["box_cols"]) * BK * c["row_bytes"]
        cb = (n0 % c["box_cols"]) * 4
        reads = []
        for i in range(4):
            key = 8 * g + 2 * ((i + gl) & 3) + par
            reads.append((key, src + (_row_offset(key, c["row_bytes"]) ^ cb)))
        keys = [8 * g + 2 * m + par for m in range(4)]  # after the rotation by gl
        pos = 8 * g + 4 * par
        box, pb = (pos // 32) * hd * 128, (pos % 32) * 4
        writes = [(n0 + j, pos, box + (_row_offset(n0 + j, 128) ^ pb), keys) for j in range(4)]
        out.append((reads, writes))
    return out


@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
def test_vt_tile_feeds_the_p_fragment(hd):
    """Every (key, column) of V lands once in V^T; read back as wgmma reads
    its K-major, 128 B-swizzled B operand (k8 step kk: box kk // 4, 32 bytes
    at (kk % 4) * 32 of row n), position t + 4c of each 8-key group holds
    key 2t + c, which is the key of S that the A fragment puts there."""
    vt = {}
    for tt in range(TRANSFORMERS):
        for _, writes in _transpose_units(hd, tt):
            for n, pos, off, keys in writes:
                for m, key in enumerate(keys):
                    assert off + 4 * m not in vt
                    vt[off + 4 * m] = (key, n)
    assert len(vt) == BK * hd
    for kk in range(BK // 8):
        for n in range(hd):
            for kap in range(8):
                byte = (kk % 4) * 32 + 4 * kap
                off = (kk // 4) * hd * 128 + n * 128 + ((((byte >> 4) ^ (n & 7))) << 4) + (byte & 15)
                key, col = vt[off]
                assert col == n
                t, c = kap % 4, kap // 4
                # a_r at position t + 4 (r >> 1) holds element frag(r): key 2t + (frag(r) & 1)
                r = next(r for r in range(4) if (r >> 1) == c)
                assert key == 8 * kk + 2 * t + (_frag(r) & 1)


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_transform_accesses_are_bank_conflict_free(hd):
    """Each quarter warp (8 lanes, one 16-byte access each) of the V^T
    transform touches 8 distinct 16-byte bank groups, reads and writes."""
    for w in range(TRANSFORMERS // 32):
        for q in range(4):
            lanes = [32 * w + 8 * q + i for i in range(8)]
            units = [_transpose_units(hd, tt) for tt in lanes]
            for p in range(min(len(u) for u in units)):
                assert len({len(u) for u in units}) == 1  # a quarter warp takes its passes together
                for i in range(4):
                    groups = {(u[p][0][i][1] >> 4) & 7 for u in units}
                    assert len(groups) == 8, (hd, w, q, p, "read", i)
                for j in range(4):
                    groups = {(u[p][1][j][2] >> 4) & 7 for u in units}
                    assert len(groups) == 8, (hd, w, q, p, "write", j)


def test_ablation_variants_match_the_sources():
    """Every substitution of tools/attn_ablation.py finds its text in the
    committed kernel sources, so the tool times what it names."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / "attn_ablation.py"
    spec = importlib.util.spec_from_file_location("attn_ablation", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert {lib for lib, _ in tool.VARIANTS} == {"pflash", "flash", "attn_f32"}
    assert {v for lib, v in tool.VARIANTS if lib == "attn_f32"} == {"as-built", "one-tf32", "no-transform", "no-exp"}
    for (lib, name), subs in tool.VARIANTS.items():
        for f, old, _ in subs:
            assert old in (tfa._cuda.CSRC_DIR / f).read_text(), (lib, name, f)
