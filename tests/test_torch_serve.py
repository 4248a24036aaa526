"""The port's serving daemon: overload and body-cap semantics, counters, and
the endpoints in front of a TINY parity codec on the CPU, on both wires."""

import http.client
import json
import sys
import threading
import time

import numpy as np

from simwhisper_codec_tpu_torch.models.codec import AudioCodec
from simwhisper_codec_tpu_torch.utils.audio_io import to_pcm16
from simwhisper_codec_tpu_torch.serve import CodecHTTPServer, MicroBatcher, make_handler, make_runner

from torch_port import TINY, jax_params, port_model


def _serve(batcher, max_body_bytes=1 << 20):
    server = CodecHTTPServer(("127.0.0.1", 0), make_handler(batcher, 16000, max_body_bytes=max_body_bytes))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.getheader("X-Code-Shape"), resp.read()
    finally:
        conn.close()


def test_overload_503_and_body_cap_413():
    release = threading.Event()

    def slow_echo(kind, payloads):
        release.wait(timeout=30)
        return payloads

    batcher = MicroBatcher(slow_echo, max_batch=1, window_ms=1.0, queue_depth=1)
    server, port = _serve(batcher, max_body_bytes=4096)
    try:
        statuses = []
        body = np.zeros(256, np.float32).tobytes()
        threads = [threading.Thread(target=lambda: statuses.append(_request(port, "POST", "/reconstruct", body)[0]))
                   for _ in range(6)]
        for th in threads:
            th.start()
            time.sleep(0.05)  # deterministic arrival order
        release.set()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert statuses.count(200) >= 2 and statuses.count(503) >= 1
        assert set(statuses) <= {200, 503}
        assert batcher.stats()["rejected"] == statuses.count(503)
        assert _request(port, "POST", "/encode", np.zeros(4096, np.float32).tobytes())[0] == 413
        status, _, raw = _request(port, "GET", "/healthz")
        assert status == 200 and json.loads(raw)["rejected"] == batcher.stats()["rejected"]
    finally:
        server.shutdown()
        server.server_close()


def test_close_runs_the_queued_requests_then_ends_the_batch_thread():
    """A closed batcher lets its runner go: a server started again in the same
    process (a test run, a benchmark) would otherwise keep every codec."""
    entered, release = threading.Event(), threading.Event()

    def runner(kind, payloads):
        entered.set()
        release.wait(timeout=30)
        return [p * 2 for p in payloads]

    batcher = MicroBatcher(runner, max_batch=4, window_ms=500.0)  # one micro-batch takes all three
    results = []
    threads = [threading.Thread(target=lambda i=i: results.append(batcher.submit("encode", i))) for i in range(3)]
    for th in threads:
        th.start()
    assert entered.wait(timeout=30)
    closer = threading.Thread(target=batcher.close, kwargs={"timeout": 30})
    closer.start()
    release.set()
    for th in threads + [closer]:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads + [closer]) and sorted(results) == [0, 2, 4]
    assert not batcher._thread.is_alive() and batcher.stats()["served"] == 3


def test_counters_survive_concurrent_updates():
    """Many threads add audio seconds at once; no update may be lost."""
    batcher = MicroBatcher(lambda kind, payloads: payloads)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [batcher.add_audio(0.5) for _ in range(2000)]) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert batcher.audio_seconds == 16 * 2000 * 0.5


def test_endpoints_with_a_tiny_codec():
    codec = AudioCodec(TINY, port_model(jax_params(0)), batch_size=2, mode="parity", device="cpu")
    server, port = _serve(MicroBatcher(make_runner(codec), max_batch=2))
    try:
        wav = (np.random.default_rng(0).standard_normal(32000) * 0.1).astype(np.float32)
        status, shape, raw = _request(port, "POST", "/encode", wav.tobytes())
        assert status == 200 and shape == "8,25"
        codes = np.frombuffer(raw, np.int32).reshape(8, 25)
        np.testing.assert_array_equal(codes, codec.encode([wav])["codes_list"][0])
        status, _, raw = _request(port, "POST", "/decode", codes.tobytes(), {"X-Code-Shape": "8,25"})
        out = np.frombuffer(raw, np.float32)
        assert status == 200 and out.shape == (25 * 1280,) and np.isfinite(out).all()
        status, _, raw = _request(port, "POST", "/reconstruct", wav.tobytes())
        np.testing.assert_allclose(np.frombuffer(raw, np.float32), out, atol=1e-6)
        status, _, raw = _request(port, "GET", "/healthz")
        health = json.loads(raw)
        assert status == 200 and health["served"] >= 3 and health["audio_seconds"] == 4.0
        assert _request(port, "GET", "/nope")[0] == 404
    finally:
        server.shutdown()
        server.server_close()


def test_pcm16_wire_answers_f32_on_the_16bit_grid():
    """--wire pcm16: the endpoints still speak f32 PCM, rescaled from the int16 decode."""
    model = port_model(jax_params(0))
    f32 = AudioCodec(TINY, model, batch_size=2, mode="parity", device="cpu")
    pcm = AudioCodec(TINY, model, batch_size=2, mode="parity", device="cpu", wire="pcm16")
    server, port = _serve(MicroBatcher(make_runner(pcm), max_batch=2))
    try:
        wav = np.random.default_rng(1).integers(-3000, 3000, 16000).astype(np.float32) / 32768.0
        status, _, raw = _request(port, "POST", "/reconstruct", wav.tobytes())
        out = np.frombuffer(raw, np.float32)
        want = f32.decode(f32.encode([wav])["codes_list"])["syn_wav_list"][0]
        assert status == 200 and out.shape == want.shape
        np.testing.assert_array_equal(out, to_pcm16(want).astype(np.float32) / 32768.0)
    finally:
        server.shutdown()
        server.server_close()
