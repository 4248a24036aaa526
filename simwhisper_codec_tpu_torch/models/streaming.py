"""Streaming codec sessions: incremental encode/decode over the chunk grid.

Counterpart of ``simwhisper_codec_tpu/models/streaming.py``.  Push audio
samples in, pull code frames out as soon as each 30 s window's stride of
context is there: the chunk arithmetic of ``AudioCodec.encode``/``decode``
(stride = 30 s - overlap), and the same one-utterance calls at the same
padded batch shape, so a flushed session gives the batch call's codes bit
for bit.  The latency floor is the stride (the algorithm's look-ahead).
The codec's single-chunk calls return device tensors; the sessions bring
them to host numpy arrays.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import torch

from simwhisper_codec_tpu_torch.models.codec import AudioCodec


def _host(x: torch.Tensor) -> np.ndarray:
    """A device tensor -> numpy (int16 PCM as it is, other floats as float32)."""
    if x.is_floating_point():
        x = x.to(torch.float32)
    return x.cpu().numpy()


class StreamingEncoder:
    """Push samples with ``feed``; collect codes; ``flush`` at the end of the stream."""

    def __init__(self, codec: AudioCodec, overlap_seconds: int = 10):
        self.codec = codec
        self.chunk_size = codec.max_audio_seconds * codec.input_sample_rate
        self.duration_size = (codec.max_audio_seconds - overlap_seconds) * codec.input_sample_rate
        self.code_duration = self.duration_size // codec.encoder_downsample_rate
        self._buffer = np.zeros(0, np.float32)
        self._total = 0

    def feed(self, samples: np.ndarray) -> Optional[np.ndarray]:
        """Append samples; returns (G, code_duration) codes when a stride
        completes, else None."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._buffer = np.concatenate([self._buffer, samples])
        self._total += len(samples)
        if len(self._buffer) >= self.chunk_size:
            return self._emit(self._buffer[: self.chunk_size], full=True)
        return None

    def _emit(self, window: np.ndarray, full: bool) -> np.ndarray:
        result = self.codec.inference_tokenize(window[None, :], np.array([len(window)]))
        codes = _host(result["codes"])[:, 0, :]
        code_len = int(result["codes_lengths"][0])
        keep = min(code_len, self.code_duration) if full else code_len
        if full:
            self._buffer = self._buffer[self.duration_size:]
        return codes[:, :keep]

    def flush(self) -> Optional[np.ndarray]:
        """Codes of the stream's tail, as the batch chunk loop makes them: the
        tail runs as further strided windows, trimmed to
        total_samples // downsample_rate."""
        total_codes = self._total // self.codec.encoder_downsample_rate
        emitted = (self._total - len(self._buffer)) // self.codec.encoder_downsample_rate
        outs: List[np.ndarray] = []
        while emitted < total_codes and len(self._buffer) > 0:
            codes = self._emit(self._buffer[: self.chunk_size], full=False)
            keep = min(codes.shape[1], self.code_duration, total_codes - emitted)
            outs.append(codes[:, :keep])
            emitted += keep
            self._buffer = self._buffer[self.duration_size:]
        return np.concatenate(outs, axis=1) if outs else None


class StreamingDecoder:
    """Push code frames with ``feed``; collect waveform strides; ``flush``."""

    def __init__(self, codec: AudioCodec, overlap_seconds: int = 10):
        self.codec = codec
        self.chunk_codes = codec.max_audio_seconds * codec.input_sample_rate // codec.encoder_downsample_rate
        self.duration_codes = ((codec.max_audio_seconds - overlap_seconds) * codec.input_sample_rate
                               // codec.encoder_downsample_rate)
        self._buffer = np.zeros((codec.num_groups, 0), np.int32)

    def feed(self, codes: np.ndarray) -> Optional[np.ndarray]:
        """Append (G, T) codes; returns a waveform stride when one is complete."""
        self._buffer = np.concatenate([self._buffer, np.asarray(codes, np.int32)], axis=1)
        if self._buffer.shape[1] >= self.chunk_codes:
            return self._emit(self._buffer[:, : self.chunk_codes], full=True)
        return None

    def _emit(self, window: np.ndarray, full: bool) -> np.ndarray:
        t = window.shape[1]
        result = self.codec.inference_detokenize(window[:, None, :], np.array([t]), chunk_width=t)
        keep = self.duration_codes if full else t
        wav = _host(result["y"][0, : keep * self.codec.decoder_upsample_rate])
        if full:
            self._buffer = self._buffer[:, self.duration_codes:]
        return wav

    def flush(self) -> Optional[np.ndarray]:
        """The tail as further strided windows (the batch call's chunks)."""
        outs: List[np.ndarray] = []
        while self._buffer.shape[1] > 0:
            window = self._buffer[:, : self.chunk_codes]
            wav = self._emit(window, full=False)
            outs.append(wav[: min(self.duration_codes, window.shape[1]) * self.codec.decoder_upsample_rate])
            self._buffer = self._buffer[:, self.duration_codes:]
        return np.concatenate(outs) if outs else None


def stream_encode(codec: AudioCodec, sample_iter: Iterator[np.ndarray], overlap_seconds: int = 10):
    """Generator: audio sample blocks in -> code blocks out (then the flushed tail)."""
    enc = StreamingEncoder(codec, overlap_seconds)
    for block in sample_iter:
        out = enc.feed(block)
        if out is not None and out.shape[1]:
            yield out
    tail = enc.flush()
    if tail is not None and tail.shape[1]:
        yield tail
