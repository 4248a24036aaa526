"""The partial modes of B2, B3 and B4 (tensor parallelism), in their plain versions.

A model rank holds a slice of the intermediate width I (W1's rows with b1
and, for int8, the row scales s1; W2's columns) and forms the f32 partial
gamma (h W2^T [+ b2]), b2 on one rank only; the model group sums the
partials and adds the residual, rounding once.  Here the ranks are slices
taken in turn (``parallel.mesh.shard``), at 2 and 4 shards:
 - B2 and B4: sum + residual equals the unsharded plain version's f32
   pre-rounding value within f32 rounding (|d| <= 2e-6 max|y|), and their
   bf16 outputs differ by at most one bf16 ulp where a sum lands on a
   rounding boundary;
 - B3: the shards' h are the unsharded h's columns bit for bit (the s8
   product is exact), the all-reduced (MAX) row maximum is the unsharded
   one, so each shard's hq equals the unsharded hq's columns exactly; sum +
   residual then equals the unsharded plain version within f32 rounding.
The CPU wrappers of the partial modes run these plain versions.
"""

import numpy as np
import pytest
import torch

from simwhisper_codec_tpu_torch.models.vocos import ConvNeXtBlock
from simwhisper_codec_tpu_torch.ops import fused_convnext as fc
from simwhisper_codec_tpu_torch.ops.quant import quantize_weight
from simwhisper_codec_tpu_torch.parallel.mesh import Mesh, shard

M, C, I = 37, 64, 256
F32_TOL = 2e-6


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


@pytest.fixture(scope="module")
def ops():
    rng = np.random.default_rng(31)
    return {"x": _rand(rng, M, C), "res": _rand(rng, M, C), "ln_w": _rand(rng, C, scale=0.1) + 1.0,
            "ln_b": _rand(rng, C, scale=0.1), "w1": _rand(rng, I, C, scale=C ** -0.5), "b1": _rand(rng, I, scale=0.02),
            "w2": _rand(rng, C, I, scale=I ** -0.5), "b2": _rand(rng, C, scale=0.02),
            "gamma": _rand(rng, C, scale=0.01) + 1.0 / 24}


def _slices(k):
    return [Mesh(1, k, 0, r) for r in range(k)]


def _close(total, want):
    assert float((total - want).abs().max()) <= F32_TOL * float(want.abs().max())


def _one_ulp(got_bf16, want_f32):
    """bf16 outputs of a sum that equals want_f32 within f32 rounding: equal
    to want's rounding, or one bf16 ulp off where want sits on a boundary."""
    want = want_f32.to(torch.bfloat16)
    ulp = torch.abs(want.to(torch.float32)) * 2.0 ** -7 + 1e-30
    assert bool(((got_bf16.to(torch.float32) - want.to(torch.float32)).abs() <= ulp).all())


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b2_partial_sum_equals_unsharded(ops, k, dtype):
    o = {key: v.to(dtype) for key, v in ops.items()}
    want = fc._ln_ffn_y_plain(o["x"], o["ln_w"], o["ln_b"], o["w1"], o["b1"], o["w2"], o["b2"], o["gamma"], 1e-6,
                              dtype) + o["res"].to(torch.float32)
    parts = [fc.ln_ffn_partial(o["x"], o["ln_w"], o["ln_b"], shard(o["w1"], 0, m), shard(o["b1"], 0, m),
                               shard(o["w2"], 1, m), o["b2"] if m.model_rank == 0 else None, o["gamma"], 1e-6)
             for m in _slices(k)]
    assert all(p.dtype == torch.float32 and p.shape == (M, C) for p in parts)
    total = sum(parts) + o["res"].to(torch.float32)
    _close(total, want)
    unsharded = fc.fused_ln_ffn_plain(o["x"], o["res"], o["ln_w"], o["ln_b"], o["w1"], o["b1"], o["w2"], o["b2"],
                                      o["gamma"], 1e-6)
    _one_ulp(total.to(dtype), unsharded.to(torch.float32))


@pytest.mark.parametrize("k", [2, 4])
def test_b3_hmax_all_reduce_gives_the_unsharded_hq(ops, k):
    bf = torch.bfloat16
    x, res = ops["x"].to(bf), ops["res"].to(bf)
    (w1q, s1), (w2q, s2) = quantize_weight(ops["w1"]), quantize_weight(ops["w2"])  # quantised whole
    args = (ops["ln_w"].to(bf), ops["ln_b"].to(bf))
    h = fc.fused_ln_ffn_int8_up_plain(x, *args, w1q, s1, ops["b1"].to(bf), 1e-6)
    hq, hs = fc._row_quant(h)
    shards = _slices(k)
    hs_parts = [fc.fused_ln_ffn_int8_up_plain(x, *args, shard(w1q, 0, m), shard(s1, 0, m),
                                              shard(ops["b1"].to(bf), 0, m), 1e-6) for m in shards]
    assert torch.equal(torch.cat(hs_parts, 1), h)
    hmax = torch.stack([p.abs().amax(-1) for p in hs_parts]).amax(0)  # the all-reduce (MAX)
    assert torch.equal(hmax, h.abs().amax(-1))
    for m, part in zip(shards, hs_parts):
        q, s = fc._row_quant(part, hmax[:, None])
        assert torch.equal(q, shard(hq, 1, m)) and torch.equal(s, hs)

    # the int32 view of the row maxima through reduce_max, as the wrapper reduces it over the group
    bits = hmax.view(torch.int32)
    seen = []

    def reduce_max(local):
        assert local.dtype == torch.int32 and bool((local <= bits).all())
        seen.append(local.clone())
        local.copy_(bits)

    parts = [fc.ln_ffn_int8_partial(x, *args, shard(w1q, 0, m), shard(s1, 0, m), shard(ops["b1"].to(bf), 0, m),
                                    shard(w2q, 1, m), s2, ops["b2"].to(bf) if m.model_rank == 0 else None,
                                    ops["gamma"].to(bf), 1e-6, reduce_max) for m in shards]
    assert len(seen) == k and torch.equal(torch.stack(seen).amax(0), bits)
    total = sum(parts) + res.to(torch.float32)
    want = fc._int8_y_plain(h, w2q, s2, ops["b2"].to(bf), ops["gamma"].to(bf), bf) + res.to(torch.float32)
    _close(total, want)
    unsharded = fc.fused_ln_ffn_int8_plain(x, res, *args, w1q, s1, ops["b1"].to(bf), w2q, s2, ops["b2"].to(bf),
                                           ops["gamma"].to(bf), 1e-6)
    _one_ulp(total.to(bf), unsharded.to(torch.float32))


@pytest.mark.parametrize("k", [2, 4])
@torch.no_grad()
def test_b4_partial_sum_equals_unsharded(k):
    bf = torch.bfloat16
    rng = np.random.default_rng(32)
    b, t = 2, 45
    x = _rand(rng, b, t, C).to(bf)
    block = ConvNeXtBlock(C, I, 1.0 / 24)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(_rand(rng, *p.shape, scale=0.1) + (1.0 if p is block.norm.weight else 0.0))
    for fv in (None, 40):
        want = fc._ln_ffn_y_plain(fc._dw_sum_plain(x, block, fv), block.norm.weight, block.norm.bias,
                                  block.pwconv1.weight, block.pwconv1.bias, block.pwconv2.weight, block.pwconv2.bias,
                                  block.gamma, 1e-6, bf).reshape(b, t, C) + x.to(torch.float32)
        parts = []
        for m in _slices(k):
            part = ConvNeXtBlock(C, I // k, 1.0 / 24)
            part.load_state_dict({key: shard(v, 0 if key.startswith("pwconv1") else 1 if key == "pwconv2.weight"
                                              else None, m) for key, v in block.state_dict().items()})
            parts.append(fc.convnext_dw_partial(x, part, fv, 1e-6, part.pwconv2.bias if m.model_rank == 0 else None))
        total = sum(parts) + x.to(torch.float32)
        _close(total, want)
        _one_ulp(total.to(bf), fc.fused_convnext_block_dw_plain(x, block, fv).to(torch.float32))
