"""The serving loop starts and stops the profiler only between micro-batches.

torch's profiler, stopped on the loop's thread while the server's batcher
thread replayed a CUDA graph, deadlocked both on the card; each runner call
holds ``Recorder.launches``, and ``between_batches`` takes it.
"""

import threading
import time

from benchmark.loops.http_open_loop import between_batches
from benchmark.spans import Recorder


def test_no_runner_call_overlaps_a_profiler_step():
    rec = Recorder()
    stepping = threading.Event()
    overlaps, calls = [], []

    def runner(kind, payloads):
        overlaps.append(stepping.is_set())
        time.sleep(0.002)
        overlaps.append(stepping.is_set())
        calls.append(kind)
        return payloads

    wrapped = rec.wrap_runner(runner, sample_rate=16000)
    done = threading.Event()

    def batcher():
        while not done.is_set():
            wrapped("encode", [])

    thread = threading.Thread(target=batcher)
    thread.start()
    try:
        for _ in range(20):
            def step():
                stepping.set()
                time.sleep(0.003)
                stepping.clear()

            between_batches(rec, step)
    finally:
        done.set()
        thread.join()
    assert calls and not any(overlaps)


def test_a_runner_call_holds_the_launch_lock():
    rec = Recorder()
    held = []
    wrapped = rec.wrap_runner(lambda kind, payloads: held.append(rec.launches.locked()), sample_rate=16000)
    wrapped("encode", [])
    assert held == [True] and not rec.launches.locked()
