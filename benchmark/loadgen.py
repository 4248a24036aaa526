"""Open-loop HTTP load generator: the client side of an ``http_open_loop`` cell.

    python3 benchmark/loadgen.py <spec.json>

Runs in a process of its own, so that its clock does not share the
server's interpreter lock.  It derives the window's requests from the mix
and the seed (``traffic.open_loop_requests``), prints ``ready``, and waits
for ``go <wall-clock start>`` on standard input.  Each request is sent at
its due time by a pool of client threads (``/encode``: f32 PCM; ``/decode``:
int32 codes with ``X-Code-Shape``) and timed from when it was due to the
last byte of its response, so a stall delays the requests behind it and
counts.  After the window it waits for the answers still out, up to
``grace_seconds`` past the close, then writes ``<out>.json`` (per request:
kind, due offset, lateness of the send, latency, status; 0 = no answer)
and ``<out>.npz`` (the answers of the seeded sample and of the longest
finished request of each kind).
"""

from __future__ import annotations

import http.client
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from pathlib import Path

import numpy as np


class Client:
    def __init__(self, spec: dict):
        from benchmark import traffic

        self.traffic = traffic
        self.spec = spec
        mix, seed = spec["mix"], spec["seed"]
        self.reqs = traffic.open_loop_requests(mix, seed, spec["seconds"], spec["sample_rate"], spec["hop_samples"])
        self.pool = traffic.noise_pool(mix, seed, spec["sample_rate"])
        self.sample = set(traffic.open_loop_sample(seed, self.reqs["kind"], mix["check_per_kind"]).tolist())
        n = len(self.reqs["due"])
        self.lateness = np.full(n, np.nan)
        self.latency = np.full(n, np.nan)
        self.status = np.zeros(n, np.int64)
        self.kept = {}
        self.longest = {0: (-1, None), 1: (-1, None)}
        self.lock = threading.Lock()

    def body(self, i: int):
        kind, length, seed = int(self.reqs["kind"][i]), int(self.reqs["length"][i]), self.spec["seed"]
        if kind == 0:
            return "/encode", self.traffic.request_audio(self.pool, length, seed, i).tobytes(), {}
        frames = length // self.spec["hop_samples"]
        codes = self.traffic.request_codes(seed, i, self.spec["groups"], frames, self.spec["levels_per_group"])
        return "/decode", codes.tobytes(), {"X-Code-Shape": f"{codes.shape[0]},{codes.shape[1]}"}

    def send(self, i: int, due: float) -> None:
        self.lateness[i] = time.monotonic() - due
        path, body, headers = self.body(i)
        status, data = 0, b""
        try:
            conn = http.client.HTTPConnection("127.0.0.1", self.spec["port"], timeout=self.spec["timeout_s"])
            try:
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                status = resp.status
            finally:
                conn.close()
        except OSError:
            status = 0
        done = time.monotonic()
        if status == 200:
            self.latency[i] = done - due
        self.status[i] = status
        if status == 200:
            kind = int(self.reqs["kind"][i])
            with self.lock:
                if i in self.sample:
                    self.kept[i] = data
                if self.reqs["length"][i] > self.longest[kind][0]:
                    self.longest[kind] = (int(self.reqs["length"][i]), i, data)

    def run(self, t_go: float) -> None:
        while time.time() < t_go:
            time.sleep(min(0.01, max(t_go - time.time(), 0.0)))
        mono0 = time.monotonic()
        futures = []
        with ThreadPoolExecutor(max_workers=self.spec["mix"]["client_threads"]) as pool:
            for i, offset in enumerate(self.reqs["due"]):
                due = mono0 + float(offset)
                delay = due - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                futures.append(pool.submit(self.send, i, due))
            deadline = mono0 + self.spec["seconds"] + self.spec["mix"]["grace_seconds"]
            wait(futures, timeout=max(deadline - time.monotonic(), 0.0))
            for f in futures:
                if f.done() and f.exception() is not None:
                    raise f.exception()
            pool.shutdown(wait=False, cancel_futures=True)
            self.write()
            os._exit(0)  # threads still waiting on an answer are abandoned; their requests count as failed

    def write(self) -> None:
        out = self.spec["out"]
        arrays = {f"ans_{i}": np.frombuffer(d, np.uint8) for i, d in self.kept.items()}
        longest = {}
        for kind, entry in self.longest.items():
            if entry[1] is not None:
                arrays[f"ans_{entry[1]}"] = np.frombuffer(entry[2], np.uint8)
                longest[kind] = entry[1]
        np.savez(out + ".npz", **arrays)
        with open(out + ".json", "w") as f:
            json.dump({"kind": self.reqs["kind"].tolist(), "length": self.reqs["length"].tolist(),
                       "due": self.reqs["due"].tolist(), "lateness": self.lateness.tolist(),
                       "latency": self.latency.tolist(), "status": self.status.tolist(),
                       "sample": sorted(self.kept), "longest": longest}, f)


def main() -> None:
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    client = Client(spec)
    print("ready", flush=True)
    line = sys.stdin.readline().split()
    if len(line) != 2 or line[0] != "go":
        sys.exit(f"loadgen: expected 'go <time>', got {line}")
    client.run(float(line[1]))


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    main()
