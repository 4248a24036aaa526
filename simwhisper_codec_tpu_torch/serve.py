"""Codec serving daemon on one GPU: HTTP encode/decode with micro-batching.

Counterpart of the repository's ``serve.py``.  A stdlib HTTP server in front
of ``AudioCodec``; requests that arrive within a short window run as one
device batch.

Endpoints (application/octet-stream unless noted):
  POST /encode      raw 16 kHz mono f32 PCM -> int32 codes (G*T), header X-Code-Shape: "G,T"
  POST /decode      int32 codes + X-Code-Shape header -> f32 PCM
  POST /reconstruct f32 PCM -> f32 PCM (round trip)
  GET  /healthz     JSON status and counters

Overload: the micro-batch queue is bounded (--queue_depth); a full queue
answers 503 with Retry-After.  Bodies above --max_body_mb answer 413 unread.

--wire pcm16 moves waveforms between host and device as int16 (half the
bytes); the endpoints still speak f32 PCM, so waveforms are quantised to the
16-bit grid on the way in and out.

Run:  python -m simwhisper_codec_tpu_torch.serve [--checkpoint SimWhisperCodec.pt] --port 8300
(without --checkpoint the weights are random, drawn from --seed).
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from simwhisper_codec_tpu_torch.utils.audio_io import set_logging

logger = logging.getLogger(__name__)


class Overloaded(Exception):
    """The micro-batch queue is full; handlers answer 503."""


class BodyTooLarge(Exception):
    """The request body exceeds the cap; handlers answer 413."""


class CodecHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose accept backlog holds a saturation burst, so
    overload reaches the bounded queue (503) instead of resetting connections."""

    request_queue_size = 128
    daemon_threads = True


class MicroBatcher:
    """Collects requests for up to ``window_ms`` and runs them as one batch.

    At most ``queue_depth`` requests wait; ``submit`` raises
    :class:`Overloaded` at once on a full queue.  Counters are updated under
    a lock (handler threads and the batch thread both write them).
    """

    def __init__(self, runner, max_batch: int = 8, window_ms: float = 5.0, queue_depth: int = 64):
        self.runner = runner
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.q: "queue.Queue" = queue.Queue(maxsize=max(1, queue_depth))
        self._lock = threading.Lock()
        self.served = 0
        self.rejected = 0
        self.audio_seconds = 0.0
        threading.Thread(target=self._loop, daemon=True).start()

    def add_audio(self, seconds: float) -> None:
        with self._lock:
            self.audio_seconds += seconds

    def submit(self, kind: str, payload):
        slot = {"kind": kind, "payload": payload, "done": threading.Event(), "result": None, "error": None}
        try:
            self.q.put_nowait(slot)
        except queue.Full:
            with self._lock:
                self.rejected += 1
            raise Overloaded(f"queue full ({self.q.maxsize} waiting)") from None
        slot["done"].wait()
        if slot["error"]:
            raise slot["error"]
        return slot["result"]

    def _loop(self):
        while True:
            batch = [self.q.get()]
            deadline = time.monotonic() + self.window_s
            while len(batch) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=timeout))
                except queue.Empty:
                    break
            by_kind: dict = {}
            for slot in batch:
                by_kind.setdefault(slot["kind"], []).append(slot)
            for kind, slots in by_kind.items():
                try:
                    for s, r in zip(slots, self.runner(kind, [s["payload"] for s in slots])):
                        s["result"] = r
                except Exception as e:  # reported to each request of the batch
                    logger.exception("batch of %d %s requests failed", len(slots), kind)
                    for s in slots:
                        s["error"] = e
                finally:
                    for s in slots:
                        s["done"].set()
            with self._lock:
                self.served += len(batch)

    def stats(self) -> dict:
        with self._lock:
            return {"served": self.served, "rejected": self.rejected,
                    "queue_depth": self.q.qsize(), "audio_seconds": round(self.audio_seconds, 1)}


def make_runner(codec):
    def runner(kind: str, payloads):
        if kind == "encode":
            return codec.encode(payloads, overlap_seconds=10)["codes_list"]
        if kind == "decode":
            return codec.decode(payloads, overlap_seconds=10)["syn_wav_list"]
        if kind == "reconstruct":
            codes = codec.encode(payloads, overlap_seconds=10)["codes_list"]
            return codec.decode(codes, overlap_seconds=10)["syn_wav_list"]
        raise ValueError(kind)

    return runner


def _wav_to_f32(wav: np.ndarray) -> np.ndarray:
    """A decoded waveform as the protocol's f32 PCM (int16 from the pcm16 wire is rescaled)."""
    if wav.dtype == np.int16:
        return wav.astype(np.float32) / 32768.0
    return np.asarray(wav, np.float32)


def make_handler(batcher: MicroBatcher, sample_rate: int, max_body_bytes: int = 64 * 1024 * 1024):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug(fmt, *args)

        def _read_body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            if n > max_body_bytes:
                raise BodyTooLarge(f"body {n} bytes > cap {max_body_bytes}")
            return self.rfile.read(n)

        def _send(self, code: int, body: bytes, headers=None):
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                body = json.dumps({"status": "ok", **batcher.stats()}).encode()
                self._send(200, body, {"Content-Type": "application/json"})
            else:
                self._send(404, b"not found")

        def do_POST(self):
            try:
                raw = self._read_body()
                if self.path == "/encode":
                    wav = np.frombuffer(raw, np.float32)
                    batcher.add_audio(len(wav) / sample_rate)
                    codes = batcher.submit("encode", wav)
                    self._send(200, np.ascontiguousarray(codes, np.int32).tobytes(),
                               {"X-Code-Shape": f"{codes.shape[0]},{codes.shape[1]}"})
                elif self.path == "/decode":
                    g, t = (int(v) for v in self.headers["X-Code-Shape"].split(","))
                    codes = np.frombuffer(raw, np.int32).reshape(g, t)
                    wav = batcher.submit("decode", codes)
                    self._send(200, _wav_to_f32(wav).tobytes())
                elif self.path == "/reconstruct":
                    wav = np.frombuffer(raw, np.float32)
                    batcher.add_audio(len(wav) / sample_rate)
                    out = batcher.submit("reconstruct", wav)
                    self._send(200, _wav_to_f32(out).tobytes())
                else:
                    self._send(404, b"not found")
            except Overloaded as e:
                self._send(503, str(e).encode(), {"Retry-After": "1"})
            except BodyTooLarge as e:
                self._send(413, str(e).encode())
            except Exception as e:  # the server keeps running; the client gets 500
                logger.exception("request failed")
                self._send(500, str(e).encode())

    return Handler


def build_codec(args):
    import torch

    from simwhisper_codec_tpu_torch.config import load_config
    from simwhisper_codec_tpu_torch.models.codec import AudioCodec, init_params

    kwargs = dict(mode=args.mode, batch_size=args.max_batch, device=args.device, wire=args.wire,
                  aot_dir=args.aot_dir)
    if args.checkpoint:
        return AudioCodec.load_from_checkpoint(args.config, args.checkpoint, **kwargs)
    cfg = load_config(args.config)
    logger.info("no --checkpoint: random weights from seed %d", args.seed)
    return AudioCodec(cfg, init_params(cfg, torch.Generator().manual_seed(args.seed)), **kwargs)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="config/SimWhisperCodec.yaml")
    p.add_argument("--checkpoint", default=None, help="reference SimWhisperCodec.pt (default: random weights)")
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights without --checkpoint")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8300)
    p.add_argument("--mode", default="fast-int8", choices=["fast", "fast-int8", "fast-int8-full", "parity"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--window_ms", type=float, default=5.0)
    p.add_argument("--queue_depth", type=int, default=64,
                   help="max requests waiting for the device; beyond this new requests get 503")
    p.add_argument("--max_body_mb", type=float, default=64.0,
                   help="reject request bodies above this size with 413 before reading them")
    p.add_argument("--wire", default="float32", choices=["float32", "pcm16"],
                   help="host<->device waveform format; pcm16 halves the bytes and quantises to 16 bits")
    p.add_argument("--aot_dir", default=None,
                   help="directory of the compiled kernel libraries, reused by later starts (also via "
                        "SIMWHISPER_AOT_DIR); the CUDA graphs are captured anew each start")
    return p


def main(argv=None):
    set_logging()
    args = build_parser().parse_args(argv)

    codec = build_codec(args)
    # first requests should not pay for start-up: builds the kernels and
    # captures both CUDA graphs before the server takes a request
    warm = [np.zeros(16000, np.float32)]
    codec.decode(codec.encode(warm)["codes_list"])
    logger.info("codec warm; serving on %s:%d (mode=%s, device=%s, wire=%s)", args.host, args.port, args.mode,
                codec.device, args.wire)

    batcher = MicroBatcher(make_runner(codec), args.max_batch, args.window_ms, queue_depth=args.queue_depth)
    server = CodecHTTPServer((args.host, args.port),
                             make_handler(batcher, codec.input_sample_rate,
                                          max_body_bytes=int(args.max_body_mb * 1024 * 1024)))
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
