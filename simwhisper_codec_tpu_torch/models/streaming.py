"""Streaming codec sessions (counterpart of ``simwhisper_codec_tpu/models/streaming.py``).

Push audio in, pull code frames out as soon as each 30 s window's stride of context is there: the
``ChunkGrid`` of ``AudioCodec.encode``/``decode`` and the same one-utterance calls at the same padded
batch shape, so a flushed session gives the batch call's codes bit for bit.  The latency floor is the
stride (the algorithm's look-ahead).  Results come home through the codec's ``HostStaging``.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from simwhisper_codec_tpu_torch.models.codec import AudioCodec, ChunkGrid


class StreamingEncoder:
    """Push samples with ``feed``; collect codes; ``flush`` at the end of the stream."""

    def __init__(self, codec: AudioCodec, overlap_seconds: int = 10):
        self.codec = codec
        self.grid = ChunkGrid.of(codec.cfg, overlap_seconds)
        self._buffer = np.zeros(0, np.float32)
        self._total = 0

    def feed(self, samples: np.ndarray) -> Optional[np.ndarray]:
        """Append samples; returns (G, kept) codes when a stride completes,
        else None.  int16 samples are taken as they are, not as x / 32768
        (``encode`` reads int16 as PCM), as the JAX package's session does."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._buffer = np.concatenate([self._buffer, samples])
        self._total += len(samples)
        if len(self._buffer) >= self.grid.chunk:
            codes = self._codes(self._buffer[: self.grid.chunk])[:, : self.grid.kept]
            self._buffer = self._buffer[self.grid.stride:]
            return codes
        return None

    def _codes(self, window: np.ndarray) -> np.ndarray:
        """The window's codes (G, T) up to the program's length for it."""
        result = self.codec.inference_tokenize(window[None, :], np.array([len(window)]))
        fetch = self.codec._wav_staging.download
        return fetch(result["codes"][:, 0, :])[:, : int(fetch(result["codes_lengths"])[0])]

    def flush(self) -> Optional[np.ndarray]:
        """The tail's codes as the batch call makes them: further strided
        windows, trimmed to total_samples // hop."""
        total_codes = self._total // self.grid.hop
        emitted = (self._total - len(self._buffer)) // self.grid.hop
        outs: List[np.ndarray] = []
        while emitted < total_codes and len(self._buffer) > 0:
            codes = self._codes(self._buffer[: self.grid.chunk])
            keep = min(codes.shape[1], self.grid.kept, total_codes - emitted)
            outs.append(codes[:, :keep])
            emitted += keep
            self._buffer = self._buffer[self.grid.stride:]
        return np.concatenate(outs, axis=1) if outs else None


class StreamingDecoder:
    """Push code frames with ``feed``; collect waveform strides; ``flush``."""

    def __init__(self, codec: AudioCodec, overlap_seconds: int = 10):
        self.codec = codec
        self.grid = ChunkGrid.of(codec.cfg, overlap_seconds)
        self._buffer = np.zeros((codec.num_groups, 0), np.int32)

    def feed(self, codes: np.ndarray) -> Optional[np.ndarray]:
        """Append (G, T) codes; returns a waveform stride when one is complete."""
        self._buffer = np.concatenate([self._buffer, np.asarray(codes, np.int32)], axis=1)
        if self._buffer.shape[1] >= self.grid.chunk_codes:
            return self._emit(self.grid.kept)
        return None

    def _emit(self, keep: int) -> np.ndarray:
        """The next window's first ``keep`` code frames decoded; the buffer moves on a stride."""
        window = self._buffer[:, : self.grid.chunk_codes]
        t = window.shape[1]
        y = self.codec.inference_detokenize(window[:, None, :], np.array([t]), chunk_width=t,
                                            out_samples=keep * self.grid.up)["y"]
        self._buffer = self._buffer[:, self.grid.kept:]
        return self.codec._code_staging.download(y[0])

    def flush(self) -> Optional[np.ndarray]:
        """The tail as further strided windows (the batch call's chunks)."""
        outs: List[np.ndarray] = []
        while self._buffer.shape[1] > 0:
            outs.append(self._emit(min(self.grid.kept, self._buffer.shape[1])))
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
