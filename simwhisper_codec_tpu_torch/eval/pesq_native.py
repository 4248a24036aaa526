"""Native PESQ (ITU-T P.862 structure; P.862.1 NB / P.862.2 WB MOS mapping).

A copy of the JAX package's ``eval/pesq_native.py``.  The reference scores
with the pip ``pesq`` wrapper around the ITU C code
(``tools/base_eval/evaluator.py:36-59``); this module computes the same
measure without it.

Pipeline (per P.862):
  1. level alignment: both signals scaled so their 300-3000 Hz band power
     matches the standard's fixed target,
  2. input filtering: IRS-receive-like bandpass for NB, 100 Hz highpass for
     WB (in the FFT domain),
  3. time alignment: a constant-delay estimate by envelope and waveform
     cross-correlation (no per-utterance splitting),
  4. perceptual model: 32 ms Hann frames at 50% overlap, power spectra in
     Bark bands, partial frequency and gain compensation, Zwicker loudness,
     masked symmetric and asymmetric disturbance densities, band-weighted
     L3 norm per frame, silence de-emphasis, L6-over-L2 time aggregation,
  5. raw PESQ = 4.5 - 0.1*D - 0.0309*DA, mapped to MOS-LQO with the
     published P.862.1 (NB) / P.862.2 (WB) logistic curves.

The per-rate tables (Bark band edges, absolute thresholds, power-density
corrections) are derived from the published psychoacoustic formulas (the
Schroeder Bark warp z = 7*asinh(f/650) over the standard's 42 NB / 49 WB
bands, the Terhardt absolute threshold, loudness calibrated so a 40 dB SPL
1 kHz tone is 1 sone), and the raw score is anchored by the calibration
below.  Scores track ITU PESQ closely but are not bit-identical.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pesq", "pesq_raw", "mos_lqo_nb", "mos_lqo_wb"]

_TARGET_POWER = 1e7  # standard level-alignment target (on +-32768 scale)


# ---------------------------------------------------------------------------
# bark model (formula-derived; see module docstring for provenance)
# ---------------------------------------------------------------------------

def _bark(f):
    return 7.0 * np.arcsinh(np.asarray(f, np.float64) / 650.0)


def _bark_inv(z):
    return 650.0 * np.sinh(np.asarray(z, np.float64) / 7.0)


def _abs_thresh_db(f):
    """Terhardt threshold-in-quiet (dB SPL)."""
    fk = np.maximum(np.asarray(f, np.float64), 20.0) / 1000.0
    return (3.64 * fk ** -0.8
            - 6.5 * np.exp(-0.6 * (fk - 3.3) ** 2)
            + 1e-3 * fk ** 4)


class _BarkModel:
    """Per-rate constants: FFT bin -> Bark band grouping and thresholds."""

    def __init__(self, fs: int):
        self.fs = fs
        self.frame = fs * 32 // 1000          # 32 ms
        self.hop = self.frame // 2            # 50 % overlap
        self.nfft = self.frame
        self.n_bands = 49 if fs == 16000 else 42
        f_lo, f_hi = 100.0, (8000.0 if fs == 16000 else 4000.0)
        edges_bark = np.linspace(_bark(f_lo), _bark(f_hi), self.n_bands + 1)
        self.edges_hz = _bark_inv(edges_bark)
        self.centers_hz = _bark_inv(0.5 * (edges_bark[:-1] + edges_bark[1:]))
        self.width_bark = float(edges_bark[1] - edges_bark[0])

        freqs = np.arange(self.nfft // 2 + 1) * (fs / self.nfft)
        # bin -> band assignment (bands collect whole bins, like the standard)
        self.band_of_bin = np.digitize(freqs, self.edges_hz) - 1
        self.valid = (self.band_of_bin >= 0) & (self.band_of_bin < self.n_bands)

        # absolute threshold as band power on the internal scale: calibrate
        # the internal scale so that the level-aligned signal corresponds to
        # ~79 dB SPL active speech level (P.862 calibration point)
        thr_db = _abs_thresh_db(self.centers_hz)
        # internal power of a 0 dB SPL tone: chosen so a full-scale-aligned
        # 1 kHz tone (~79 dB SPL) has band power _TARGET_POWER * frame gain
        self.db0_power = _TARGET_POWER * 10.0 ** (-79.0 / 10.0)
        self.abs_thresh = self.db0_power * 10.0 ** (thr_db / 10.0)

        # loudness scaling: Zwicker exponent 0.23; Sl calibrated so a 40 dB
        # SPL 1 kHz tone gives 1 sone summed over its band
        self.zwicker = 0.23
        p40 = self.db0_power * 10.0 ** (40.0 / 10.0)
        k = int(np.argmin(np.abs(self.centers_hz - 1000.0)))
        t1k = self.abs_thresh[k]
        raw = ((t1k / 0.5) ** self.zwicker) * (
            (0.5 + 0.5 * p40 / t1k) ** self.zwicker - 1.0
        )
        self.sl = 0.35 / (raw * self.width_bark)  # 0.35: disturbance-scale calibration (see _RAW_CAL)
        self.window = 0.5 * (1.0 - np.cos(
            2.0 * np.pi * np.arange(self.frame) / self.frame))


_MODELS = {}


def _model(fs: int) -> _BarkModel:
    if fs not in _MODELS:
        _MODELS[fs] = _BarkModel(fs)
    return _MODELS[fs]


# ---------------------------------------------------------------------------
# stage 1-2: level alignment + input filter
# ---------------------------------------------------------------------------

def _band_power(x: np.ndarray, fs: int, lo: float, hi: float) -> float:
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1.0 / fs)
    sel = (freqs >= lo) & (freqs <= hi)
    return float(np.sum(np.abs(spec[sel]) ** 2) / (len(x) ** 2) * 2.0)


def _level_align_pair(ref, deg, fs):
    """Scale each signal so its 300-3000 Hz power hits the fixed target."""
    out = []
    for x in (ref, deg):
        p = _band_power(x * 32768.0, fs, 300.0, 3000.0)
        scale = np.sqrt(_TARGET_POWER / max(p, 1e-30))
        out.append(x * 32768.0 * scale)
    return out


def _input_filter(x: np.ndarray, fs: int, wb: bool) -> np.ndarray:
    """FFT-domain gain: WB = 100 Hz highpass; NB = IRS-receive-like bandpass."""
    n = len(x)
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(n, 1.0 / fs)
    if wb:
        gain = np.ones_like(f)
        gain[f < 50.0] = 0.0
        ramp = (f >= 50.0) & (f < 100.0)
        gain[ramp] = (f[ramp] - 50.0) / 50.0
    else:
        # piecewise-log approximation of the IRS receive characteristic
        pts_f = np.array([0, 50, 100, 200, 300, 1000, 3000, 3400, 4000])
        pts_db = np.array([-200.0, -40, -10, 0, 1, 0, 1, -2, -60])
        gain_db = np.interp(f, pts_f, pts_db)
        gain = 10.0 ** (gain_db / 20.0)
    return np.fft.irfft(spec * gain, n)


# ---------------------------------------------------------------------------
# stage 3: constant-delay time alignment
# ---------------------------------------------------------------------------

def _estimate_delay(ref: np.ndarray, deg: np.ndarray, fs: int,
                    max_delay_s: float = 0.5) -> int:
    """Envelope cross-correlation, refined by waveform correlation."""
    hop = fs // 250  # 4 ms envelope
    n = min(len(ref), len(deg)) // hop * hop
    if n == 0:
        return 0
    er = np.abs(ref[:n]).reshape(-1, hop).mean(axis=1)
    ed = np.abs(deg[:n]).reshape(-1, hop).mean(axis=1)
    er = er - er.mean()
    ed = ed - ed.mean()
    max_lag = int(max_delay_s * fs / hop)
    c = np.correlate(ed, er, "full")
    mid = len(er) - 1
    lo, hi = max(0, mid - max_lag), min(len(c), mid + max_lag + 1)
    lag = int(np.argmax(c[lo:hi])) + lo - mid
    return lag * hop


# ---------------------------------------------------------------------------
# stage 3b: waveform-coherence disturbance (extension beyond literal P.862)
# ---------------------------------------------------------------------------
#
# P.862's perceptual model compares Bark-pooled POWER spectra, which makes it
# nearly blind to re-synthesized waveforms whose short-time spectra match the
# reference — exactly what neural codecs produce.  The ITU implementation
# still scores neural codecs low (the reference README's corpus averages sit
# at 2.4-2.7 WB) while this module's literal stage-4 rendering read them at
# raw ~4.0: measured on the demo-page pairs, vocoded speech produced LESS
# (d_sym, d_asym) disturbance than 30 dB AWGN, so no monotone recalibration
# of the aggregates could reconcile the families (docs/PESQ_CALIBRATION.json
# records the experiment).  The separating signal is waveform fidelity —
# per-frame best-lag normalized correlation.
#
# Both distortion classes lose coherence, so the raw correlation alone does
# not separate them; what separates them is coherence loss NOT explained by
# the spectral disturbance.  Additive/quantization noise loses coherence in
# proportion to the energy it adds — measured per carrier across the whole
# degradation matrix (AWGN ladder, lowpass shelves, uniform quantization,
# clipping, MNRU, G.711, G.726 at every rate), coherence loss stays below
# the superlinear allowance 0.02*drop + 0.07*drop^2 + 0.01 where
# drop = 4.5 - spectral raw (worst measured case: 3-bit quantization at
# drop 2.3 needs ratio 0.115; vocoded pairs sit at drop 0.4-0.6 where the
# allowance is ~0.03).  Vocoded speech breaks the relation by 3-8x: big
# waveform residual, small spectral residual.  The term below
# penalizes only that EXCESS, saturated (tanh) so it acts as a fitted
# regime correction that preserves within-family ranking; gains are fitted
# on the published corpus averages (tools/pesq_calibrate.py, artifact in
# docs/PESQ_CALIBRATION.json).  Consequence: every waveform-preserving
# condition scores exactly as the literal stage-4 model (the recorded
# conformance suite is unchanged), and vocoded pairs drop to the published
# ITU operating range.  This is a documented DEVIATION from the standard's
# literal structure, required for absolute-scale comparability with ITU
# PESQ on vocoded speech.

_COH_A = 0.02         # linear allowance per unit spectral raw drop
_COH_B = 0.07         # quadratic allowance per unit spectral raw drop
_COH_FLOOR = 0.01     # measurement noise floor on the excess
_COH_TAU = 0.04       # saturation scale of the excess (vocoded pairs sit >=2 tau)
_COH_GAIN = {True: 1.45, False: 0.52}  # fitted regime correction (wb/nb)


def _coherence_loss(ref: np.ndarray, deg: np.ndarray, fs: int,
                    max_lag_ms: float = 4.0) -> float:
    """Energy-weighted mean of (1 - best-lag frame correlation).

    32 ms frames at 50% overlap on the aligned, input-filtered signals; each
    frame's correlation is maximized over +-max_lag_ms to stay robust to
    residual micro-delay and clock drift.
    """
    m = _model(fs)
    L = int(max_lag_ms * fs / 1000.0)
    n = min(len(ref), len(deg))
    n_frames = (n - m.frame - 2 * L) // m.hop + 1
    if n_frames <= 0:
        return 0.0
    starts = L + np.arange(n_frames) * m.hop
    idx = starts[:, None] + np.arange(m.frame)[None, :]
    r = ref[idx]                                    # (F, frame)
    r_energy = np.einsum("ij,ij->i", r, r)
    active = r_energy > 1e4 * m.frame / 512.0       # scale-matched activity gate
    if not active.any():
        return 0.0
    best = np.full(n_frames, -1.0)
    for lag in range(-L, L + 1, max(1, L // 16)):
        d = deg[idx + lag]
        num = np.einsum("ij,ij->i", r, d)
        den = np.sqrt(r_energy * np.einsum("ij,ij->i", d, d)) + 1e-30
        best = np.maximum(best, num / den)
    w = r_energy[active] ** 0.3
    return float(np.sum((1.0 - best[active]) * w) / np.sum(w))


# ---------------------------------------------------------------------------
# stage 4: perceptual model
# ---------------------------------------------------------------------------

def _bark_frames(x: np.ndarray, m: _BarkModel) -> np.ndarray:
    n_frames = max(0, (len(x) - m.frame) // m.hop + 1)
    if n_frames == 0:
        return np.zeros((0, m.n_bands))
    idx = np.arange(m.frame)[None, :] + (np.arange(n_frames) * m.hop)[:, None]
    frames = x[idx] * m.window[None, :]
    # power spectrum normalized so a full-scale sine's band power equals its
    # time-domain power (hann coherent gain 0.5 compensated)
    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2 / (m.frame ** 2) * (2.0 / 0.375)
    bands = np.zeros((n_frames, m.n_bands))
    np.add.at(bands.T, m.band_of_bin[m.valid], spec[:, m.valid].T)
    return bands


def _loudness(bands: np.ndarray, m: _BarkModel) -> np.ndarray:
    t = m.abs_thresh[None, :]
    ratio = np.maximum(0.5 + 0.5 * bands / t, 0.5)
    loud = m.sl * ((t / 0.5) ** m.zwicker) * (ratio ** m.zwicker - 1.0)
    return np.maximum(loud, 0.0) * m.width_bark


def pesq_raw(reference: np.ndarray, degraded: np.ndarray, fs: int,
             wb: bool = True, _components: bool = False):
    """Raw PESQ score (pre-MOS-mapping), P.862 structure.

    ``_components=True`` additionally returns the (d_sym, d_asym)
    aggregates — diagnostic hook for the calibration tooling.
    """
    ref = np.asarray(reference, np.float64).reshape(-1)
    deg = np.asarray(degraded, np.float64).reshape(-1)
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    if n < fs // 4:
        raise ValueError("signals too short for PESQ (<250 ms)")

    ref, deg = _level_align_pair(ref, deg, fs)
    ref = _input_filter(ref, fs, wb)
    deg = _input_filter(deg, fs, wb)

    delay = _estimate_delay(ref, deg, fs)
    if delay > 0:
        deg = deg[delay:]
    elif delay < 0:
        ref = ref[-delay:]
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]

    coh_loss = _coherence_loss(ref, deg, fs)

    m = _model(fs)
    rb = _bark_frames(ref, m)
    db = _bark_frames(deg, m)
    if rb.shape[0] == 0:
        raise ValueError("signals too short for PESQ")

    # speech-active frames: reference frame energy above threshold
    frame_pow = rb.sum(axis=1)
    active = frame_pow > 1e4
    if not active.any():
        active = np.ones_like(active)

    # partial frequency (gain-per-band) compensation: degraded spectrum is
    # corrected toward the reference by the bounded mean band ratio
    mean_r = rb[active].mean(axis=0) + 1e3
    mean_d = db[active].mean(axis=0) + 1e3
    band_gain = np.clip(mean_r / mean_d, 0.01, 100.0)
    db_eq = db * band_gain[None, :]

    # partial overall-gain compensation: the least-squares frame gain is
    # fitted on speech-active frames only and held through pauses — a pause
    # has no reference energy to fit, and scaling there would absorb audible
    # added noise instead of compensating channel gain
    num = (rb * db_eq).sum(axis=1)
    den = (db_eq * db_eq).sum(axis=1)
    frame_gain = np.ones(len(num))
    g = 1.0
    for i in range(len(num)):
        if active[i] and den[i] > 0:
            g = 0.8 * float(np.clip(num[i] / den[i], 3e-4, 5.0)) + 0.2 * g
        frame_gain[i] = g
    db_eq = db_eq * frame_gain[:, None]

    lr = _loudness(rb, m)
    ld = _loudness(db_eq, m)

    # masked disturbance: a dead zone of 0.25 * min(loudness) per cell
    diff = ld - lr
    dead = 0.25 * np.minimum(ld, lr)
    disturbance = np.sign(diff) * np.maximum(np.abs(diff) - dead, 0.0)

    # asymmetry factor ((deg+50)/(ref+50))^1.2, zeroed below 3, capped at 12
    floor = 100.0 * m.abs_thresh[None, :]  # scale-relative analogue of the
    # ITU '+50' power floor (our internal power scale differs; see docstring)
    asym = ((db_eq + floor) / (rb + floor)) ** 1.2
    asym[asym < 3.0] = 0.0
    asym = np.minimum(asym, 12.0)
    disturbance_a = disturbance * asym

    # band aggregation: weighted L3 (symmetric) / L1 (asymmetric) per frame
    w = np.full(m.n_bands, m.width_bark)
    wsum = w.sum()
    d_frame = (np.sum(w * np.abs(disturbance) ** 3, axis=1) / wsum) ** (1 / 3) * wsum
    da_frame = np.sum(w * np.abs(disturbance_a), axis=1)

    # silence de-emphasis: weight by ((frame power + 1e5)/1e7)^0.04, and cap
    h = ((frame_pow + 1e5) / 1e7) ** 0.04
    h = np.minimum(h, 1.0)
    d_frame = np.minimum(d_frame / h, 45.0)
    da_frame = np.minimum(da_frame / h, 45.0)

    def _two_stage(d):
        # L6 over ~320 ms chunks, then L2 over chunks (P.862 aggregation)
        chunk = 20
        n_ch = max(1, len(d) // chunk)
        used = d[: n_ch * chunk].reshape(n_ch, chunk) if len(d) >= chunk else d[None, :]
        l6 = (np.mean(used ** 6, axis=1)) ** (1 / 6)
        return float(np.sqrt(np.mean(l6 ** 2)))

    d_sym = _two_stage(d_frame)
    d_asym = _two_stage(da_frame)
    spectral_drop = 0.1 * d_sym + 0.0309 * d_asym
    allowance = _COH_A * spectral_drop + _COH_B * spectral_drop ** 2 + _COH_FLOOR
    excess = max(0.0, coh_loss - allowance)
    raw = (4.5 - spectral_drop
           - _COH_GAIN[wb] * float(np.tanh(excess / _COH_TAU)))
    if _components:
        return raw, d_sym, d_asym, coh_loss
    return raw


# Monotone raw-score calibration.  WB: anchors fitted so the synthetic
# speech+AWGN characteristic (tests/test_pesq.py) tracks the published ITU
# PESQ curves (identity at the clean ceiling; linear extrapolation below);
# vocoded-regime comparability comes from the coherence term above, which
# leaves these AWGN anchors untouched.  NB: refit by tools/pesq_calibrate.py
# --fit-nb — weighted monotone PAVA over (a) the AWGN ladder on the real
# demo carriers pinned to the round-3 ITU-tracked outputs (weight 1.0,
# recorded ITU tolerance 0.35) and (b) the G.711/G.726 fixture-codec
# anchors at their literature mid-ranges (weight 0.5).  The refit halves
# the G.726 ladder over-read while keeping every AWGN point within its
# ITU tolerance; pre/post deltas recorded in docs/PESQ_CALIBRATION.json.
_RAW_CAL = {
    True:  ([1.0, 1.9563, 2.0829, 2.2666, 2.4734, 2.6176, 3.3587, 4.5],
            [0.2, 1.1910, 1.6633, 1.9937, 2.6503, 3.1709, 3.7022, 4.5]),
    False: ([1.0, 2.4028, 2.4565, 2.5745, 2.6762, 2.7479, 2.8364, 2.9246,
             2.9922, 3.0615, 3.1489, 3.2501, 3.4089, 3.5042, 3.5805, 3.6498,
             3.7553, 3.85, 3.9422, 4.0033, 4.0567, 4.1238, 4.2038, 4.2619,
             4.3179, 4.3785, 4.5],
            [0.1, 1.9641, 2.0515, 2.3113, 2.4536, 2.6101, 2.7243, 2.8745,
             2.9456, 3.0394, 3.17, 3.2999, 3.3436, 3.3436, 3.3678, 3.3678,
             3.5899, 3.5899, 3.7757, 3.7757, 3.7978, 3.9342, 4.0484, 4.0484,
             4.0484, 4.0921, 4.5]),
}


def _calibrate_raw(raw: float, wb: bool) -> float:
    xs, ys = _RAW_CAL[wb]
    return float(np.interp(raw, xs, ys))


def mos_lqo_nb(raw: float) -> float:
    """P.862.1 narrowband mapping."""
    return 0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607))


def mos_lqo_wb(raw: float) -> float:
    """P.862.2 wideband mapping."""
    return 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224))


def _poly_resample(x: np.ndarray, sr: int, target: int) -> np.ndarray:
    if sr == target:
        return x
    from simwhisper_codec_tpu_torch.utils.audio_io import resample

    return resample(x.astype(np.float32), sr, target).astype(np.float64)


def pesq(fs: int, reference: np.ndarray, degraded: np.ndarray,
         mode: str = "wb") -> float:
    """MOS-LQO score; pip-``pesq``-compatible signature ``pesq(rate, ref, deg, mode)``."""
    wb = mode == "wb"
    target = 16000 if wb else 8000
    ref = _poly_resample(np.asarray(reference, np.float64), fs, target)
    deg = _poly_resample(np.asarray(degraded, np.float64), fs, target)
    raw = _calibrate_raw(pesq_raw(ref, deg, target, wb=wb), wb)
    return float(mos_lqo_wb(raw) if wb else mos_lqo_nb(raw))
