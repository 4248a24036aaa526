"""Speech quality and intelligibility metrics in numpy and scipy.

A copy of the JAX package's ``eval/metrics.py`` (the reference scores with
the ``pesq`` and ``pystoi`` pip packages, ``tools/base_eval/evaluator.py:13-101``):

 - STOI: the Taal et al. 2010 short-time objective intelligibility measure
   (10 kHz resample, silent-frame removal, 1/3-octave bands, 384 ms
   segments, clipped correlation), as pystoi implements it.
 - SI-SNR, SNR, LSD, MCD.
 - PESQ: the ``pesq`` ITU wrapper when it imports, else the native P.862 of
   ``eval/pesq_native.py``; ``have_pesq()`` says which runs.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def _resample(x: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    if sr == target_sr:
        return x
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr, target_sr)
    return resample_poly(x, target_sr // g, sr // g)


# ---------------------------------------------------------------------------
# STOI (Taal, Hendriks, Heusdens, Jensen, 2010)
# ---------------------------------------------------------------------------

_STOI_FS = 10000
_STOI_N_FRAME = 256
_STOI_NFFT = 512
_STOI_NUM_BANDS = 15
_STOI_MIN_FREQ = 150.0
_STOI_N = 30          # analysis segment length (frames) = 384 ms
_STOI_BETA = -15.0    # lower SDR bound (dB)
_STOI_DYN_RANGE = 40  # silent-frame removal energy range (dB)


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float) -> np.ndarray:
    """1/3-octave band matrix (num_bands, nfft//2+1)."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands)
    cf = 2.0 ** (k / 3.0) * min_freq
    freq_low = cf * 2.0 ** (-1.0 / 6.0)
    freq_high = cf * 2.0 ** (1.0 / 6.0)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        f_bin_low = np.argmin((f - freq_low[i]) ** 2)
        f_bin_high = np.argmin((f - freq_high[i]) ** 2)
        obm[i, f_bin_low:f_bin_high] = 1.0
    return obm


def _stft_frames(x: np.ndarray, n_frame: int, nfft: int, hop: int) -> np.ndarray:
    n = (len(x) - n_frame) // hop + 1
    if n <= 0:
        return np.zeros((0, nfft // 2 + 1))
    idx = np.arange(n)[:, None] * hop + np.arange(n_frame)[None, :]
    frames = x[idx] * np.hanning(n_frame + 2)[1:-1]
    return np.fft.rfft(frames, nfft, axis=-1)


def _remove_silent_frames(
    x: np.ndarray, y: np.ndarray, dyn_range: float, n_frame: int, hop: int
) -> Tuple[np.ndarray, np.ndarray]:
    n = (len(x) - n_frame) // hop + 1
    idx = np.arange(n)[:, None] * hop + np.arange(n_frame)[None, :]
    w = np.hanning(n_frame + 2)[1:-1]
    x_frames = x[idx] * w
    y_frames = y[idx] * w
    energies = 20 * np.log10(np.linalg.norm(x_frames, axis=1) + 1e-12)
    mask = energies > (energies.max() - dyn_range)
    x_frames, y_frames = x_frames[mask], y_frames[mask]
    # overlap-add back
    n_kept = len(x_frames)
    out_len = (n_kept - 1) * hop + n_frame if n_kept else 0
    x_out = np.zeros(out_len)
    y_out = np.zeros(out_len)
    for i in range(n_kept):
        x_out[i * hop : i * hop + n_frame] += x_frames[i]
        y_out[i * hop : i * hop + n_frame] += y_frames[i]
    return x_out, y_out


def stoi(reference: np.ndarray, degraded: np.ndarray, sample_rate: int) -> float:
    """Short-Time Objective Intelligibility (classic, non-extended)."""
    if len(reference) != len(degraded):
        m = min(len(reference), len(degraded))
        reference, degraded = reference[:m], degraded[:m]

    x = _resample(np.asarray(reference, np.float64), sample_rate, _STOI_FS)
    y = _resample(np.asarray(degraded, np.float64), sample_rate, _STOI_FS)

    hop = _STOI_N_FRAME // 2
    x, y = _remove_silent_frames(x, y, _STOI_DYN_RANGE, _STOI_N_FRAME, hop)
    if len(x) < _STOI_N_FRAME * 2:
        return float("nan")

    X = np.abs(_stft_frames(x, _STOI_N_FRAME, _STOI_NFFT, hop)) ** 2  # (T, F)
    Y = np.abs(_stft_frames(y, _STOI_N_FRAME, _STOI_NFFT, hop)) ** 2
    obm = _thirdoct(_STOI_FS, _STOI_NFFT, _STOI_NUM_BANDS, _STOI_MIN_FREQ)

    Xb = np.sqrt(X @ obm.T)  # (T, bands)
    Yb = np.sqrt(Y @ obm.T)
    if Xb.shape[0] < _STOI_N:
        return float("nan")

    d_sum, count = 0.0, 0
    c = 10 ** (-_STOI_BETA / 20.0)
    for m in range(_STOI_N, Xb.shape[0] + 1):
        Xseg = Xb[m - _STOI_N : m]  # (N, bands)
        Yseg = Yb[m - _STOI_N : m]
        # normalize + clip
        alpha = np.sqrt(np.sum(Xseg**2, axis=0) / (np.sum(Yseg**2, axis=0) + 1e-12))
        Yprime = np.minimum(Yseg * alpha[None, :], Xseg * (1 + c))
        # per-band correlation
        xn = Xseg - Xseg.mean(axis=0, keepdims=True)
        yn = Yprime - Yprime.mean(axis=0, keepdims=True)
        num = np.sum(xn * yn, axis=0)
        den = np.linalg.norm(xn, axis=0) * np.linalg.norm(yn, axis=0) + 1e-12
        d_sum += float(np.sum(num / den))
        count += _STOI_NUM_BANDS
    return d_sum / count


# ---------------------------------------------------------------------------
# Simple native metrics
# ---------------------------------------------------------------------------


def si_snr(reference: np.ndarray, estimate: np.ndarray) -> float:
    """Scale-invariant SNR in dB."""
    m = min(len(reference), len(estimate))
    s, x = np.asarray(reference[:m], np.float64), np.asarray(estimate[:m], np.float64)
    s = s - s.mean()
    x = x - x.mean()
    t = (np.dot(x, s) / (np.dot(s, s) + 1e-12)) * s
    e = x - t
    return float(10 * np.log10((np.dot(t, t) + 1e-12) / (np.dot(e, e) + 1e-12)))


def snr(reference: np.ndarray, estimate: np.ndarray) -> float:
    m = min(len(reference), len(estimate))
    s, x = np.asarray(reference[:m], np.float64), np.asarray(estimate[:m], np.float64)
    noise = s - x
    return float(10 * np.log10((np.dot(s, s) + 1e-12) / (np.dot(noise, noise) + 1e-12)))


def log_spectral_distance(
    reference: np.ndarray, estimate: np.ndarray, n_fft: int = 1024, hop: int = 256
) -> float:
    """RMS log-spectral distance (dB)."""
    m = min(len(reference), len(estimate))
    X = _stft_frames(np.asarray(reference[:m], np.float64), n_fft, n_fft, hop)
    Y = _stft_frames(np.asarray(estimate[:m], np.float64), n_fft, n_fft, hop)
    px = 20 * np.log10(np.abs(X) + 1e-8)
    py = 20 * np.log10(np.abs(Y) + 1e-8)
    return float(np.mean(np.sqrt(np.mean((px - py) ** 2, axis=-1))))


def mel_cepstral_distortion(
    reference: np.ndarray, estimate: np.ndarray, sample_rate: int, n_mfcc: int = 13
) -> float:
    """MCD (dB) over DCT of log-mel energies (no DTW; frame-aligned signals)."""
    from simwhisper_codec_tpu_torch.ops.mel import slaney_mel_filter_bank

    m = min(len(reference), len(estimate))
    n_fft, hop = 1024, 256
    fb = slaney_mel_filter_bank(n_fft // 2 + 1, 40, 0.0, sample_rate / 2, sample_rate)

    def mfcc(sig):
        S = np.abs(_stft_frames(np.asarray(sig, np.float64), n_fft, n_fft, hop)) ** 2
        logm = np.log10(np.maximum(S @ fb, 1e-10))
        import scipy.fftpack

        return scipy.fftpack.dct(logm, type=2, axis=-1, norm="ortho")[:, 1:n_mfcc]

    cx, cy = mfcc(reference[:m]), mfcc(estimate[:m])
    t = min(len(cx), len(cy))
    diff = cx[:t] - cy[:t]
    return float((10.0 / np.log(10)) * np.sqrt(2.0) * np.mean(np.sqrt(np.sum(diff**2, axis=-1))))


# ---------------------------------------------------------------------------
# PESQ delegation
# ---------------------------------------------------------------------------


def have_pesq() -> bool:
    try:
        import pesq  # noqa: F401

        return True
    except ImportError:
        return False


def pesq_score(
    reference: np.ndarray, degraded: np.ndarray, sample_rate: int, mode: str = "wb"
) -> Optional[float]:
    """ITU-T P.862 PESQ MOS-LQO.

    Uses the pip ``pesq`` ITU wrapper when installed (exact reference-C
    parity, matching the reference harness
    tools/base_eval/evaluator.py:13-101); otherwise falls back to the native
    implementation (eval/pesq_native.py — P.862 structure with
    formula-derived tables, anchor-calibrated; see its docstring for the
    fidelity statement).  Signals are length-matched and clipped to [-1, 1]
    by the caller.
    """
    rate = 16000 if mode == "wb" else 8000
    ref = _resample(np.asarray(reference, np.float64), sample_rate, rate)
    deg = _resample(np.asarray(degraded, np.float64), sample_rate, rate)
    m = min(len(ref), len(deg))
    # expected unscorable-pair errors: the native implementation raises
    # ValueError (<250 ms, no frames); the pip ITU wrapper raises PesqError
    # subclasses (NoUtterancesError, BufferTooShortError) which do NOT
    # derive from ValueError.  Anything else is a real bug and propagates.
    unscorable: tuple = (ValueError,)
    try:
        if have_pesq():
            from pesq import PesqError, pesq as _pesq

            unscorable = (ValueError, PesqError)
            return float(_pesq(rate, ref[:m], deg[:m], mode))
        from simwhisper_codec_tpu_torch.eval.pesq_native import pesq as _native_pesq

        return float(_native_pesq(rate, ref[:m], deg[:m], mode))
    except unscorable as e:
        # omit PESQ for this pair instead of aborting the corpus run — the
        # same outward behavior the harness had when pesq was absent
        logger.warning("PESQ unscorable pair (%s): omitted", e)
        return None
