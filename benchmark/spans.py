"""Spans and counters that the harness records around its calls into the program.

- ``ProgramSpan`` wraps one of ``AudioCodec``'s two serving programs
  (``tokenize``, ``detokenize``): a ``bench.<direction>`` profiler range
  around the call, the input's batch rows and time axis, and the hand
  kernels' launches it made (the delta of ``ops._cuda.launch_counts``,
  which a CUDA-graph replay adds to as an eager call would).
- ``wrap_runner`` wraps the runner that ``serve.make_runner`` returns: a
  ``bench.runner.<kind>`` range, the requests per call and the input audio
  seconds, and, for decode calls, which chunk width each payload was
  decoded at (the longest payload of its call), for the correctness check.

Calls are recorded only while ``Recorder.active`` is set (the measured
window), and flagged ``traced`` while the profiler runs.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, List

import numpy as np
import torch


def payload_digest(codes: np.ndarray) -> str:
    return hashlib.blake2b(np.ascontiguousarray(codes, np.int32).tobytes(), digest_size=12).hexdigest()


class Recorder:
    def __init__(self):
        self.active = False
        self.tracing = False
        self.program_calls: List[dict] = []
        self.runner_calls: List[dict] = []
        self.decode_width: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, kind: str, record: dict) -> None:
        if self.active:
            record["traced"] = self.tracing
            with self._lock:
                (self.program_calls if kind == "program" else self.runner_calls).append(record)

    def wrap_codec(self, codec) -> None:
        codec._tokenize = ProgramSpan(codec._tokenize, "tokenize", self)
        codec._detokenize = ProgramSpan(codec._detokenize, "detokenize", self)

    def wrap_runner(self, runner, sample_rate: int):
        def traced_runner(kind: str, payloads):
            if kind == "decode":
                width = max(p.shape[-1] for p in payloads)
                for p in payloads:
                    self.decode_width[payload_digest(p)] = width
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"bench.runner.{kind}"):
                out = runner(kind, payloads)
            audio_s = sum(len(p) for p in payloads) / sample_rate if kind != "decode" else 0.0
            self.add("runner", {"kind": kind, "requests": len(payloads), "input_audio_s": audio_s,
                                "seconds": time.perf_counter() - t0})
            return out

        return traced_runner


class ProgramSpan:
    """A serving program with a profiler range and a record around each call."""

    def __init__(self, program, direction: str, recorder: Recorder):
        self._program, self.direction, self._rec = program, direction, recorder

    def __getattr__(self, name):  # count, source, ... of the wrapped program
        return getattr(self._program, name)

    def __call__(self, *args):
        from simwhisper_codec_tpu_torch.ops import _cuda

        before = dict(_cuda.launch_counts)
        with torch.profiler.record_function(f"bench.{self.direction}"):
            out = self._program(*args)
        launches = {k: n - before.get(k, 0) for k, n in _cuda.launch_counts.items() if n != before.get(k, 0)}
        x = args[0]
        batch, frames = (x.shape[0], x.shape[1]) if self.direction == "tokenize" else (x.shape[1], x.shape[2])
        self._rec.add("program", {"direction": self.direction, "batch": int(batch), "frames": int(frames),
                                  "launches": launches})
        return out
