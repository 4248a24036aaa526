"""Host-side audio I/O: load/resample/save, length probes, file discovery, logging setup.

Reference ``utils/helpers.py``: load_audio (:77-93), save_audio (:95-103),
find_audio_files (:105-111), set_logging (:60-75).  The port's own copy of
``simwhisper_codec_tpu/utils/audio_io.py``: stdlib ``wave`` for WAV PCM,
the numpy FLAC decoder (``utils/flac.py``), the system libmpg123 for MP3
(``utils/mp3.py``), soundfile only as a last resort, and a numpy
implementation of torchaudio's default resampler (windowed-sinc polyphase,
``sinc_interp_hann``, lowpass_filter_width=6, rolloff=0.99), so resampled
inputs produce the reference pipeline's codes.
"""

from __future__ import annotations

import logging
import os
import wave
from math import gcd
from typing import List, Optional

import numpy as np

AUDIO_EXTENSIONS = (".flac", ".mp3", ".wav")


def set_logging(level=logging.INFO) -> None:
    """RANK-tagged logging format."""
    rank = int(os.environ.get("RANK", 0))
    logging.basicConfig(
        level=level,
        format=f"%(asctime)s [RANK {rank}] (%(module)s:%(lineno)d) %(levelname)s : %(message)s",
        force=True,
    )


def sinc_hann_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6, rolloff: float = 0.99,
                     dtype=np.float64) -> tuple:
    """torchaudio ``_get_sinc_resample_kernel`` (sinc_interp_hann defaults).

    Frequencies must already be reduced by their gcd.  Returns
    ``(kernels (new_freq, 2*width + orig_freq), width)``: one windowed-sinc
    filter per output phase, sampled on the input grid, scaled by
    ``base_freq / orig_freq``.
    """
    base_freq = min(orig_freq, new_freq) * rolloff
    width = int(np.ceil(lowpass_filter_width * orig_freq / base_freq))
    idx = np.arange(-width, width + orig_freq, dtype=dtype)[None, :] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=dtype)[:, None] / new_freq + idx
    t = np.clip(t * base_freq, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t_pi = t * np.pi
    with np.errstate(invalid="ignore", divide="ignore"):
        kernels = np.where(t_pi == 0, 1.0, np.sin(t_pi) / t_pi)
    kernels *= window * (base_freq / orig_freq)
    return kernels, width


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Windowed-sinc polyphase resampling, torchaudio-equivalent: per-phase
    hann-windowed sinc filters applied at stride ``orig_freq`` and
    interleaved, output trimmed to ``ceil(len * new / orig)``."""
    if orig_sr == target_sr:
        return wav
    g = gcd(int(orig_sr), int(target_sr))
    orig_freq, new_freq = int(orig_sr) // g, int(target_sr) // g
    length = wav.shape[-1]
    kernels, width = sinc_hann_kernel(orig_freq, new_freq)

    x = np.pad(np.asarray(wav, np.float64), (width, width + orig_freq))
    # frames of the padded signal at stride orig_freq, one kernel-width each:
    # output[phase, frame] = kernels[phase] . x[frame*orig : frame*orig + K]
    k = kernels.shape[1]
    n_frames = (x.shape[-1] - k) // orig_freq + 1
    frames = np.lib.stride_tricks.as_strided(
        x, shape=(n_frames, k), strides=(x.strides[-1] * orig_freq, x.strides[-1]),
    )
    out = (frames @ kernels.T).reshape(-1)  # interleave phases
    target_length = -(-length * new_freq // orig_freq)  # ceil
    return out[:target_length].astype(np.float32)


def _load_wav_stdlib(path: str) -> tuple:
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        ch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if ch > 1:
        data = data.reshape(-1, ch)
    return data, sr


def load_audio(path: str, target_sample_rate: int = 16000) -> np.ndarray:
    """Load audio -> mono float32 at the target rate (helpers.py:77-93
    semantics: channel mean, then resampling).

    WAV through stdlib ``wave``, FLAC through ``utils/flac.py``, MP3 through
    the system libmpg123 (``utils/mp3.py``); soundfile only for anything
    those cannot read.  Raises ``RuntimeError`` when nothing decodes the
    file, carrying the native decoder's error where there was one.
    """
    path = str(path)
    data: Optional[np.ndarray] = None
    sr = None
    lower = path.lower()
    if lower.endswith(".wav"):
        try:
            data, sr = _load_wav_stdlib(path)
        except Exception:
            data = None
    native_err: Optional[Exception] = None
    if data is None and lower.endswith(".flac"):
        from simwhisper_codec_tpu_torch.utils.flac import read_flac

        try:
            data, sr = read_flac(path)
        except Exception as e:  # an unusual file: let soundfile try
            native_err = e
            data = None
    if data is None and lower.endswith(".mp3"):
        from simwhisper_codec_tpu_torch.utils import mp3

        if mp3.have_mpg123():
            try:
                data, sr = mp3.read_mp3(path)
            except Exception as e:
                native_err = e
                data = None
    if data is None:
        try:
            import soundfile as sf

            data, sr = sf.read(path, dtype="float32")
        except ImportError as e:
            if native_err is not None:  # surface the decoder's own error
                raise RuntimeError(
                    f"cannot decode {path}: native decoder failed "
                    f"({native_err}) and soundfile is unavailable"
                ) from native_err
            raise RuntimeError(
                f"cannot decode {path}: no native decoder for this format and "
                "soundfile is unavailable"
            ) from e
    if data.ndim > 1:
        data = data.mean(axis=1)  # mono mix, matching torch.mean(dim=0)
    return resample(data.astype(np.float32), sr, target_sample_rate)


def probe_audio_length(path: str, target_sample_rate: int = 16000) -> int:
    """Length in samples at the target rate, from the header where the
    format has one (WAV frame count, FLAC STREAMINFO, an MP3 scan), so that
    length bucketing does not hold a corpus in memory; else a full decode."""
    path = str(path)
    n = sr = None
    lower = path.lower()
    try:
        if lower.endswith(".wav"):
            with wave.open(path, "rb") as f:
                n, sr = f.getnframes(), f.getframerate()
        elif lower.endswith(".flac"):
            from simwhisper_codec_tpu_torch.utils.flac import probe_flac

            info = probe_flac(path)
            if info["total_samples"]:
                n, sr = info["total_samples"], info["sample_rate"]
        elif lower.endswith(".mp3"):
            from simwhisper_codec_tpu_torch.utils import mp3

            if mp3.have_mpg123():
                n, sr, _ch = mp3.probe_mp3(path)
    except Exception:
        n = None
    if n is not None:
        if sr == target_sample_rate:
            return n
        g = gcd(sr, target_sample_rate)
        return -(-n * (target_sample_rate // g) // (sr // g))  # the resampler's ceil length
    return len(load_audio(path, target_sample_rate))


def to_pcm16(wav: np.ndarray) -> np.ndarray:
    """Float waveform -> int16 PCM: x * 32768, clipped, truncated toward zero
    (the reference's 16-bit save, helpers.py:95-103)."""
    return np.clip(np.asarray(wav, np.float32) * 32768.0, -32768, 32767).astype(np.int16)


def save_audio(path: str, wav: np.ndarray, sample_rate: int = 16000) -> None:
    """Save 16-bit PCM WAV (helpers.py:95-103: PCM_S, bits 16).

    int16 input is written as-is (the codec's ``wire="pcm16"`` path already
    quantised it on the device with the formula of ``to_pcm16``)."""
    wav = np.asarray(wav)
    pcm = (wav if wav.dtype == np.int16 else to_pcm16(wav)).reshape(-1).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def find_audio_files(input_dir: str) -> List[str]:
    """Recursively find flac/mp3/wav files, sorted (helpers.py:105-111)."""
    out: List[str] = []
    for root, _dirs, files in os.walk(input_dir):
        for name in files:
            if name.lower().endswith(AUDIO_EXTENSIONS):
                out.append(os.path.join(root, name))
    return sorted(out)
