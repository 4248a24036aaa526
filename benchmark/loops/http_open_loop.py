"""Open loop against the real HTTP server.

The harness writes the seed's weights as a reference-layout ``.pt`` and
the configuration as YAML under ``$TMPDIR``, then runs
``simwhisper_codec_tpu_torch.serve.main`` in a thread of this process with
the configuration's mode, the mix's ``server_flags``, a free port and
``--aot_dir``.  Two things are wrapped, nothing else changed: the runner
that ``serve.make_runner`` returns (spans of the micro-batches, and the
codec's two programs, ``spans.Recorder``), and the server class, to stop it
after the window.  The load generator (``loadgen.py``) runs in a child
process; the window starts when the server has answered one request of
each kind.  Latency is from when a request was due to the last byte of its
answer, over every request due in the window.  A request refused (503),
failed or unanswered counts in ``failed``, and in the latency set as one
answered at the load generator's deadline (the window's close plus
``grace_seconds``), the earliest it could have been answered had it been
answered at all: shedding load cannot shorten the tail.

After the window the server is stopped (its micro-batch thread, a daemon,
keeps the codec), the peak memory read, and the reference checks the
seeded sample of answers and the longest of each kind: encode answers
against its values before rounding, decode answers against its decode of
the same codes at the width the server decoded them at (the longest
request of the same micro-batch).
"""

from __future__ import annotations

import http.client
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import judge, traffic
from benchmark.cell import Run, log, peak_bytes, reset_peak
from benchmark.devtrace import DeviceTrace
from benchmark.reference import ReferenceCodec, float32_exact
from benchmark.spans import Recorder, payload_digest
from benchmark.weights import make_state

HERE = Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def post(port: int, path: str, body: bytes, headers=None, timeout=600.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class Server:
    """``serve.main`` in a thread, with the harness's recorder around its runner."""

    def __init__(self, run: Run, recorder: Recorder):
        self.run, self.rec = run, recorder
        self.port = free_port()
        self.httpd = None
        self.error = None
        self.files = []
        self.thread = None

    def start(self) -> None:
        from simwhisper_codec_tpu_torch import serve

        run = self.run
        tmp = run.tmpdir
        ckpt = os.path.join(tmp, f"bench-weights-{os.getpid()}.pt")
        cfg_path = os.path.join(tmp, f"bench-config-{os.getpid()}.yaml")
        self.files = [ckpt, cfg_path]
        state = make_state(run.gp, run.seed, run.device)
        torch.save({k: v.cpu() for k, v in state.items()}, ckpt)
        del state
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
        reset_peak(run.device)
        with open(cfg_path, "w") as f:
            json.dump({"generator_params": run.gp}, f)  # JSON is YAML
        rec, sr = self.rec, run.gp["input_sample_rate"]
        make_runner = serve.make_runner
        holder = self

        def recorded_runner(codec):
            rec.wrap_codec(codec)
            return rec.wrap_runner(make_runner(codec), sr)

        class StoppableServer(serve.CodecHTTPServer):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                holder.httpd = self

        self._restore = (serve, make_runner, serve.CodecHTTPServer)
        serve.make_runner = recorded_runner
        serve.CodecHTTPServer = StoppableServer
        argv = ["--config", cfg_path, "--checkpoint", ckpt, "--mode", run.config["mode"], "--port", str(self.port),
                "--device", str(run.device), "--aot_dir", str(run.aot_dir), *run.mix["server_flags"]]

        def serve_main():
            try:
                serve.main(argv)
            except BaseException as e:  # reported by wait_ready / stop
                self.error = e

        self.thread = threading.Thread(target=serve_main, name="serve-main", daemon=True)
        self.thread.start()

    def wait_ready(self, timeout: float = 1200.0) -> None:
        deadline = time.monotonic() + timeout
        while self.httpd is None:
            if self.error is not None or not self.thread.is_alive():
                raise RuntimeError(f"the server did not start: {self.error!r}")
            if time.monotonic() > deadline:
                raise TimeoutError("the server did not start in time")
            time.sleep(0.05)

    def stop(self) -> None:
        if self.thread is None:
            return
        if self.httpd is not None:
            self.httpd.shutdown()
        self.thread.join(timeout=60)
        serve, serve.make_runner, serve.CodecHTTPServer = self._restore
        for path in self.files:
            if os.path.exists(path):
                os.remove(path)


def client_spec(run: Run, port: int, out: str, seconds: float, mix: dict) -> dict:
    gp = run.gp
    q = gp["quantizer"]
    return {"port": port, "seed": run.seed, "seconds": seconds, "mix": mix, "out": out,
            "sample_rate": gp["input_sample_rate"], "groups": q["num_groups"],
            "levels_per_group": int(np.prod(q["num_levels_per_group"])), "hop_samples": gp["encoder_downsample_rate"],
            "timeout_s": seconds + mix["grace_seconds"] + 30}


class LoadGenerator:
    """``loadgen.py`` in a child process, started early; ``go`` starts its window."""

    def __init__(self, run: Run, port: int, seconds: float, mix: dict, tag: str = "load"):
        self.out = os.path.join(run.tmpdir, f"bench-{tag}-{os.getpid()}")
        spec = client_spec(run, port, self.out, seconds, mix)
        self.spec_path = self.out + ".spec.json"
        with open(self.spec_path, "w") as f:
            json.dump(spec, f)
        self.seconds = seconds
        self.grace = mix["grace_seconds"]
        self.proc = subprocess.Popen([sys.executable, str(HERE / "loadgen.py"), self.spec_path],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def ready(self) -> None:
        line = self.proc.stdout.readline().strip()
        if line != "ready":
            raise RuntimeError(f"the load generator did not start: {line!r}")

    def go(self, t_go: float) -> None:
        self.proc.stdin.write(f"go {t_go!r}\n")
        self.proc.stdin.flush()

    def results(self) -> tuple:
        try:
            rc = self.proc.wait(timeout=self.seconds + self.grace + 120)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        if rc != 0:
            raise RuntimeError(f"the load generator exited {rc}")
        with open(self.out + ".json") as f:
            res = json.load(f)
        answers = dict(np.load(self.out + ".npz"))
        return res, answers

    def kill(self) -> None:
        """Stop the child if it still runs, and remove its files."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        for suffix in (".json", ".npz", ".spec.json"):
            if os.path.exists(self.out + suffix):
                os.remove(self.out + suffix)


def warm_requests(run: Run, port: int) -> None:
    """One request of each kind through the whole server, before the window."""
    gp, sr = run.gp, run.gp["input_sample_rate"]
    wav = traffic.noise_pool({"pool_seconds": 5, "noise_sigma": 0.1}, run.seed ^ 0x5EED, sr)
    status, body = post(port, "/encode", wav.tobytes())
    if status != 200:
        raise RuntimeError(f"warm-up /encode answered {status}: {body[:200]!r}")
    g, t = gp["quantizer"]["num_groups"], len(wav) // gp["encoder_downsample_rate"]
    status, body = post(port, "/decode", body, {"X-Code-Shape": f"{g},{t}"})
    if status != 200:
        raise RuntimeError(f"warm-up /decode answered {status}: {body[:200]!r}")


def latency_stats(res: dict, deadline_s: float) -> dict:
    """Every request's latency; one not answered 200 counts as answered at
    ``deadline_s`` (seconds after the window's start)."""
    status = np.asarray(res["status"])
    ok = status == 200
    lat = np.where(ok, np.asarray(res["latency"], dtype=np.float64),
                   deadline_s - np.asarray(res["due"], dtype=np.float64))
    return {"attempted": len(status), "failed": int((~ok).sum()), "refused": int((status == 503).sum()),
            "latency_s": lat, "lateness_s": np.asarray(res["lateness"], dtype=np.float64)}


def run(run: Run) -> None:
    mix = run.mix
    rec = run.recorder = Recorder()
    server = Server(run, rec)
    load = LoadGenerator(run, server.port, run.seconds, mix)
    try:
        server.start()
        server.wait_ready()
        warm_requests(run, server.port)
        load.ready()
        trace = DeviceTrace(run.tmpdir, run.device) if run.trace else None
        if trace is not None:
            trace.warm(lambda: warm_requests(run, server.port))
        t_go = time.time() + 0.05
        run.setup_s = t_go - run.t_start
        load.go(t_go)
        while time.time() < t_go:
            time.sleep(0.001)
        rec.active = True
        if trace is not None:
            time.sleep(run.seconds * mix["trace_start_share"])
            trace.start()
            rec.tracing = True
            time.sleep(mix["trace_seconds"])
            rec.tracing = False
            trace.stop()
        res, answers = load.results()
        if trace is not None:
            run.trace_summary = trace.summarise()
        rec.active = False
        run.memory_peak_bytes = peak_bytes(run.device)
    finally:
        load.kill()
        server.stop()
    stats = latency_stats(res, run.seconds + mix["grace_seconds"])
    run.attempted, run.failed = stats["attempted"], stats["failed"]
    lat_ms = stats["latency_s"] * 1e3
    run.end_to_end["request_p50_ms"] = percentile(lat_ms, 50)
    run.end_to_end["request_p95_ms"] = percentile(lat_ms, 95)
    run.counters.update(refused=stats["refused"], window_s=run.seconds,
                        lateness_p95_ms=percentile(stats["lateness_s"][np.isfinite(stats["lateness_s"])] * 1e3, 95))
    log(f"serve: {run.attempted} requests, {run.failed} failed ({stats['refused']} refused), "
        f"p50 {run.end_to_end['request_p50_ms']:.3f} ms, p95 {run.end_to_end['request_p95_ms']:.3f} ms, "
        f"send lateness p95 {run.counters['lateness_p95_ms']:.3f} ms, {len(rec.runner_calls)} micro-batches")
    run.checked = (res, rec)
    run.numbers = check(run, res, answers, rec)
    run.numbers["low_precision_launches"] = float(
        judge.low_precision_launches(rec.program_calls, run.config["precision"]))


def percentile(values: np.ndarray, q: float) -> float:
    """The q-th percentile of all values, linear between order statistics (nan if none)."""
    values = np.sort(np.asarray(values, dtype=np.float64))
    if len(values) == 0:
        return float("nan")
    pos = (len(values) - 1) * q / 100.0
    lo = int(np.floor(pos))
    hi = min(lo + 1, len(values) - 1)
    return float(values[lo] + (values[hi] - values[lo]) * (pos - lo))


def checked_requests(run: Run, res: dict, rec: Recorder) -> tuple:
    """(encode requests: [(index, audio)], decode requests: [(index, codes, width)]) that
    are checked: the seeded sample and the longest answered of each kind; a decode
    request whose micro-batch was not recorded has width None."""
    gp, seed = run.gp, run.seed
    q = gp["quantizer"]
    hop = gp["encoder_downsample_rate"]
    pool = traffic.noise_pool(run.mix, seed, gp["input_sample_rate"])
    checked = sorted(set(res["sample"]) | {int(i) for i in res["longest"].values()})
    enc = [(i, traffic.request_audio(pool, res["length"][i], seed, i)) for i in checked if res["kind"][i] == 0]
    lpg = int(np.prod(q["num_levels_per_group"]))
    dec = []
    for i in checked:
        if res["kind"][i] == 1:
            codes = traffic.request_codes(seed, i, q["num_groups"], res["length"][i] // hop, lpg)
            dec.append((i, codes, rec.decode_width.get(payload_digest(codes))))
    return enc, dec


def check(run: Run, res: dict, answers: dict, rec: Recorder, reference=None) -> dict:
    gp, seed = run.gp, run.seed
    q = gp["quantizer"]
    groups, levels, hop = q["num_groups"], q["num_levels_per_group"], gp["encoder_downsample_rate"]
    enc, dec = checked_requests(run, res, rec)
    t0 = time.perf_counter()
    ref = reference or ReferenceCodec(gp, make_state(gp, seed, run.device))
    gaps, errs, bad = [], [], 0
    with torch.no_grad(), float32_exact():
        for (i, w), (_, lv) in zip(enc, ref.encode([w for _, w in enc], run.mix["overlap_seconds"])):
            n = len(w) // hop
            got = np.frombuffer(answers[f"ans_{i}"].tobytes(), np.int32)
            if got.size != groups * n:
                bad += 1
                continue
            gaps.append(judge.code_gap(got.reshape(groups, n), lv, levels))
        known = [(i, c, w) for i, c, w in dec if w is not None]
        bad += len(dec) - len(known)
        outs = ref.decode([c for _, c, _ in known], [w for _, _, w in known], run.mix["overlap_seconds"])
        for (i, c, _), y in zip(known, outs):
            got = np.frombuffer(answers[f"ans_{i}"].tobytes(), np.float32)
            if judge.shape_error(got, y.shape):
                bad += 1
                continue
            errs.append(judge.wav_err(got, y))
    log(f"reference: {len(enc)} encode and {len(dec)} decode answers in {time.perf_counter() - t0:.3f} s")
    return {"code_gap": max(gaps, default=float("nan")), "wav_err": max(errs, default=float("nan")),
            "shape_errors": float(bad)}
