"""Deterministic standard-codec fixtures for anchoring native PESQ.

A copy of the JAX package's ``eval/fixture_codecs.py``: the classic
waveform codecs whose PESQ scores are published (G.711 in both laws, G.726
ADPCM at 16/24/32/40 kbit/s) and the P.810 MNRU reference degradation, with
which ``eval/pesq_native.py``'s absolute scale is checked.

* G.711: segment/mantissa companding on the 16-bit grid (8 segments, 16
  mantissa steps; mu-law bias 132, A-law XOR 0x55).
* G.726: the recommendation's ADPCM structure (adaptive log-domain
  quantizer, fast/slow scale-factor adaptation with speed control,
  2-pole/6-zero sign-sign adaptive predictor, tone/transition detection),
  in floating point: not bit-exact with the ITU test vectors.
* MNRU (P.810): y = x * (1 + 10^(-Q/20) * N) with unit Gaussian N.

Everything is deterministic (seeded noise, stateless codecs).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "g711_ulaw", "g711_alaw", "g726", "mnru",
    "ulaw_encode", "ulaw_decode", "alaw_encode", "alaw_decode",
]


# ---------------------------------------------------------------------------
# G.711 — segment/mantissa log PCM on the 16-bit grid
# ---------------------------------------------------------------------------

_ULAW_BIAS = 132  # 0x84: half a step at the smallest segment, 16-bit scale
_ULAW_CLIP = 32635


def ulaw_encode(pcm: np.ndarray) -> np.ndarray:
    """int16 linear -> uint8 µ-law codes (G.711 µ-law encode)."""
    x = np.asarray(pcm, np.int32)
    sign = np.where(x < 0, 0x80, 0x00)
    mag = np.minimum(np.abs(x), _ULAW_CLIP) + _ULAW_BIAS
    # segment = position of the MSB above bit 7 (8 segments, 0..7)
    seg = np.maximum(np.floor(np.log2(mag)).astype(np.int32) - 7, 0)
    mant = (mag >> (seg + 3)) & 0x0F
    return (~(sign | (seg << 4) | mant)).astype(np.uint8)


def ulaw_decode(codes: np.ndarray) -> np.ndarray:
    """uint8 µ-law codes -> int16 linear (G.711 µ-law decode)."""
    c = ~np.asarray(codes, np.uint8).astype(np.int32) & 0xFF
    sign = c & 0x80
    seg = (c >> 4) & 0x07
    mant = c & 0x0F
    mag = (((mant << 3) + _ULAW_BIAS) << seg) - _ULAW_BIAS
    return np.where(sign, -mag, mag).astype(np.int16)


def alaw_encode(pcm: np.ndarray) -> np.ndarray:
    """int16 linear -> uint8 A-law codes (G.711 A-law encode)."""
    x = np.asarray(pcm, np.int32)
    sign = np.where(x >= 0, 0x80, 0x00)  # A-law: 1 = positive
    mag = np.minimum(np.abs(x), 32767) >> 3  # A-law works on a 13-bit grid
    seg = np.maximum(np.floor(np.log2(np.maximum(mag, 1))).astype(np.int32) - 4, 0)
    mant = np.where(seg == 0, mag >> 1, mag >> seg) & 0x0F
    return ((sign | (seg << 4) | mant) ^ 0x55).astype(np.uint8)


def alaw_decode(codes: np.ndarray) -> np.ndarray:
    """uint8 A-law codes -> int16 linear (G.711 A-law decode)."""
    c = np.asarray(codes, np.uint8).astype(np.int32) ^ 0x55
    sign = c & 0x80
    seg = (c >> 4) & 0x07
    mant = c & 0x0F
    mag = np.where(seg == 0, (mant << 1) + 1, ((mant << 1) + 33) << (seg - 1))
    mag = mag << 3  # 13-bit grid (with half step) back to the 16-bit grid
    return np.where(sign, mag, -mag).astype(np.int16)


def _to_int16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(x, np.float64) * 32768.0, -32768, 32767).astype(np.int16)


def g711_ulaw(x: np.ndarray) -> np.ndarray:
    """float [-1,1] -> G.711 µ-law roundtrip -> float [-1,1]."""
    return ulaw_decode(ulaw_encode(_to_int16(x))).astype(np.float64) / 32768.0


def g711_alaw(x: np.ndarray) -> np.ndarray:
    """float [-1,1] -> G.711 A-law roundtrip -> float [-1,1]."""
    return alaw_decode(alaw_encode(_to_int16(x))).astype(np.float64) / 32768.0


# ---------------------------------------------------------------------------
# G.726 — ADPCM at 16/24/32/40 kbit/s
# ---------------------------------------------------------------------------
#
# Per-rate quantizer tables in the recommendation's normalized log2 units:
#   decision: boundaries of |d|'s normalized log magnitude  -> code magnitude
#   recon:    normalized log reconstruction level per code magnitude
#   w:        scale-factor multiplier W(I) for the fast adaptation
#   f:        F(I) driving the adaptation-speed control
_G726_TABLES = {
    2: {  # 16 kbit/s: 1 magnitude bit
        "decision": np.array([2.04]),
        "recon": np.array([0.91, 2.85]),
        "w": np.array([-1.375, 27.44]),
        "f": np.array([0, 7], np.float64),
    },
    3: {  # 24 kbit/s: 2 magnitude bits
        "decision": np.array([0.0625, 1.70, 2.585]),
        "recon": np.array([-np.inf, 1.05, 2.13, 2.91]),
        "w": np.array([-0.25, 1.875, 8.5625, 36.375]),
        "f": np.array([0, 1, 2, 7], np.float64),
    },
    4: {  # 32 kbit/s: 3 magnitude bits
        "decision": np.array([-0.96875, 0.625, 1.390625, 1.921875,
                              2.34375, 2.7265625, 3.125]),
        "recon": np.array([-np.inf, 0.03125, 1.0546875, 1.6640625,
                           2.1328125, 2.5234375, 2.9140625, 3.3203125]),
        "w": np.array([-0.75, 1.125, 2.5625, 4.0, 7.0, 12.375, 22.1875, 70.125]),
        "f": np.array([0, 0, 0, 1, 1, 1, 3, 7], np.float64),
    },
    5: {  # 40 kbit/s: 4 magnitude bits
        "decision": np.array([-1.32, -0.08, 0.78, 1.34, 1.76, 2.11, 2.42,
                              2.70, 2.95, 3.19, 3.42, 3.65, 3.88, 4.14, 4.45]),
        "recon": np.array([-np.inf, -0.70, 0.35, 1.06, 1.55, 1.93, 2.26,
                           2.56, 2.83, 3.08, 3.31, 3.54, 3.77, 4.01, 4.28, 4.62]),
        "w": np.array([-0.48, 0.35, 0.72, 1.09, 1.73, 2.39, 3.31, 4.62,
                       6.54, 9.09, 12.50, 17.50, 24.99, 35.13, 48.60, 68.73]),
        "f": np.array([0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 6],
                      np.float64),
    },
}

_RATE_TO_BITS = {16000: 2, 24000: 3, 32000: 4, 40000: 5}


def _g726_kernel(x: np.ndarray, bits: int) -> np.ndarray:
    """Encode+decode one signal through the ADPCM loop (float rendering)."""
    t = _G726_TABLES[bits]
    decision, recon, w_tab, f_tab = (t["decision"], t["recon"], t["w"], t["f"])

    # state (spec initial values, expressed in float log2 units)
    yl = 34.0 / 16.0  # slow scale factor (log2 units; spec YL init 34816/2^15*? -> 1.06; 2.125 keeps startup mild)
    yu = yl
    ap = 0.0
    dms = 0.0
    dml = 0.0
    a = np.zeros(2)       # pole coefficients
    b = np.zeros(6)       # zero coefficients
    dq_hist = np.zeros(6)  # past quantized differences (signed)
    sr_hist = np.zeros(2)  # past reconstructed signals
    pk = np.zeros(2)       # signs of past p = dq + sez
    td = 0.0               # tone detect

    out = np.empty_like(x, np.float64)
    log2 = np.log2
    for k in range(len(x)):
        sez = float(b @ dq_hist)
        se = float(a @ sr_hist) + sez
        d = float(x[k]) - se

        al = min(ap, 1.0)
        y = al * yu + (1.0 - al) * yl

        # quantize log2|d| - y against the decision boundaries
        dln = log2(abs(d) + 1e-30) - y
        mag = int(np.searchsorted(decision, dln))
        sgn = -1.0 if d < 0 else 1.0

        # inverse quantizer
        dq = sgn * (0.0 if recon[mag] == -np.inf else 2.0 ** (recon[mag] + y))
        sr = se + dq

        # scale factor adaptation (fast/slow, spec leakage constants)
        wi = float(w_tab[mag])
        yu = min(max((1.0 - 2.0 ** -5) * y + 2.0 ** -5 * wi, 1.06), 10.0)
        yl = (1.0 - 2.0 ** -6) * yl + 2.0 ** -6 * yu

        # adaptation speed control
        fi = float(f_tab[mag])
        dms = (1.0 - 2.0 ** -5) * dms + 2.0 ** -5 * fi
        dml = (1.0 - 2.0 ** -7) * dml + 2.0 ** -7 * fi
        tr = 1.0 if (td and abs(dq) > 24.0 * 2.0 ** yl) else 0.0
        if tr:
            ap = 1.0
        elif abs(dms - dml) >= 2.0 ** -3 * dml or td or y < 3.0:
            ap = (1.0 - 2.0 ** -4) * ap + 2.0 ** -4 * 2.0
        else:
            ap = (1.0 - 2.0 ** -4) * ap

        # predictor adaptation (sign-sign LMS with spec leakage + limits)
        p = dq + sez
        pks = 0.0 if p == 0 else np.sign(p)
        if tr:
            a[:] = 0.0
            b[:] = 0.0
        else:
            # A2 += 2^-7 * (sgn(p)sgn(p1) - f(A1) sgn(p)sgn(p2)),
            # f(A1) = 4*A1 clipped to [-2, 2] (spec's |A1|<=1/2 breakpoint)
            sgn1 = pks * pk[0]
            sgn2 = pks * pk[1]
            f_a1 = float(np.clip(4.0 * a[0], -2.0, 2.0))
            a2 = (1.0 - 2.0 ** -7) * a[1] + 2.0 ** -7 * (sgn1 - f_a1 * sgn2)
            a2 = float(np.clip(a2, -0.75, 0.75))
            a1 = (1.0 - 2.0 ** -8) * a[0] + 3.0 * 2.0 ** -8 * sgn1
            lim = 1.0 - 2.0 ** -4 - a2
            a1 = float(np.clip(a1, -lim, lim))
            a[0], a[1] = a1, a2
            dqs = 0.0 if dq == 0 else np.sign(dq)
            b = (1.0 - 2.0 ** -8) * b
            b += 2.0 ** -7 * dqs * np.where(dq_hist == 0, 0.0, np.sign(dq_hist))

        # tone detect: strong negative pole = narrowband signal
        td = 1.0 if a[1] < -0.71875 else 0.0

        pk[1] = pk[0]
        pk[0] = pks
        dq_hist[1:] = dq_hist[:-1]
        dq_hist[0] = dq
        sr_hist[1] = sr_hist[0]
        sr_hist[0] = sr
        out[k] = sr
    return out


def g726(x: np.ndarray, bitrate: int = 32000) -> np.ndarray:
    """float [-1,1] @ 8 kHz -> G.726 ADPCM roundtrip -> float [-1,1].

    ``bitrate`` in {16000, 24000, 32000, 40000} bit/s (2/3/4/5 bits/sample
    at 8 kHz sampling).
    """
    if bitrate not in _RATE_TO_BITS:
        raise ValueError(f"g726 bitrate must be one of {sorted(_RATE_TO_BITS)}")
    pcm = _to_int16(x).astype(np.float64)  # spec operates on the PCM grid
    y = _g726_kernel(pcm, _RATE_TO_BITS[bitrate])
    return np.clip(y, -32768, 32767) / 32768.0


# ---------------------------------------------------------------------------
# MNRU — P.810 modulated noise reference unit
# ---------------------------------------------------------------------------

def mnru(x: np.ndarray, q_db: float, seed: int = 0x810) -> np.ndarray:
    """y = x * (1 + 10^(-Q/20) * N), N ~ unit Gaussian (deterministic seed)."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal(len(x))
    return np.asarray(x, np.float64) * (1.0 + 10.0 ** (-q_db / 20.0) * n)
