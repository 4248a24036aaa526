"""Compiled programs: each codec direction, and each training step, captured
once per input signature as a CUDA graph.

Counterpart of ``simwhisper_codec_tpu/utils/aot.py`` (``warm_jit``) and of
the ``jax.jit`` programs of the JAX ``AudioCodec`` and trainers: there each
is one compiled program per padded input shape; here it is one
``torch.cuda.CUDAGraph`` per signature, the signature being the input
tensors' shapes, dtypes and devices plus the math flags a capture bakes in
(TF32 for matmuls and cuDNN, cuDNN's deterministic / benchmark / enabled
flags, the float32 matmul precision, deterministic algorithms), as
``warm_jit._aval_sig`` keys on the avals.

On CUDA the first call of a signature
  1. runs the function once, eagerly, on a side stream: that builds and
     loads the kernel libraries (``ops/_cuda.py``), runs each kernel's
     ``cudaFuncSetAttribute`` and sets up cuBLAS and cuDNN; its outputs are
     the call's result;
  2. copies the inputs into static buffers and captures the function into
     a graph, in the memory pool given (one per ``AudioCodec``, shared by
     both directions), with ``capture_error_mode="thread_local"`` so that
     another thread's CUDA calls (a server's handlers) do not break it.
     A capture that fails raises: nothing falls back to eager on the card.
Every later call copies its inputs into the static buffers, replays, and
returns clones of the static outputs, so a result the caller holds is
never overwritten by the next replay.  Because the pool is shared and
outputs are cloned right after their replay, graphs may replay in any order.

The launch counts of ``ops._cuda.launch_counts`` keep their meaning: the
wrappers' counting runs in Python, which a replay never reaches, so the
launches recorded during the capture are taken back out of the counts and
added again at every replay (the warm-up's launches are real ones and
count).  A call therefore counts the same launches eagerly, captured or
replayed.

On the CPU (what the tests run) and for a program made with
``capture=False`` (a model sharded by ``parallel/mesh.py``: its gloo
collectives cannot be captured) the signatures are counted the same way,
as ``jax.jit`` traces on the CPU too, and the function runs eagerly.
Inside ``eager()``, the counterpart of ``jax.disable_jit()``, every program
runs its function eagerly and counts nothing: checks that must see the
Python calls (a monkeypatched wrapper) run there.

Graphs live only in the process: a later process skips ``nvcc`` through
the kernel libraries kept under ``aot_dir`` (``ops._cuda.use_aot_dir``),
but captures again, so ``count`` counts captures where the JAX package's
``trace_counts`` stays 0 on a warm start.

A training step (``StepProgram``, the twin of the trainers' ``warm_jit`` /
``jax.jit`` of the step) writes its state in place: the parameters, the
optimizer moments and step counts, the spectral-norm vectors and the
gradients, and returns 0-d tensors.  Its first call of a signature is a
real step (the warm-up); the capture after it records the step without
running it.  Its function may have no Python side effect (a step counter,
a host read): the capture runs the Python once more, a replay never.  A
state dict loaded into one of its models or optimizers drops its graphs
(``Optimizer.load_state_dict`` replaces the moment tensors a graph would go
on writing); the next call warms up and captures again.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import Callable, Dict, Iterable, Optional

import torch

from simwhisper_codec_tpu_torch.ops import _cuda

_local = threading.local()


@contextlib.contextmanager
def eager():
    """Run every ``CapturedProgram`` of this thread eagerly, uncounted, inside the block."""
    prev = getattr(_local, "eager", False)
    _local.eager = True
    try:
        yield
    finally:
        _local.eager = prev


def _flags() -> tuple:
    cudnn = torch.backends.cudnn
    return (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
            cudnn.enabled, torch.get_float32_matmul_precision(), torch.are_deterministic_algorithms_enabled())


def signature(args) -> tuple:
    """The key of a program: each input tensor's shape, dtype and device, and the math flags."""
    for a in args:
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"a captured program takes tensors only, got {type(a).__name__}")
    return tuple((tuple(a.shape), a.dtype, a.device) for a in args) + (_flags(),)


def _map(fn, out):
    """``fn`` over the tensors of a dict / list / tuple of tensors."""
    if isinstance(out, dict):
        return {k: _map(fn, v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_map(fn, v) for v in out)
    return fn(out)


class GraphPool:
    """One CUDA graph memory pool, made at the first capture, for the programs given it."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


class _Graph:
    """One captured signature: the graph, its static inputs and outputs, the launches it replays."""

    def __init__(self, graph, inputs, outputs, launches: Dict[str, int]):
        self.graph, self.inputs, self.outputs, self.launches = graph, inputs, outputs, launches

    def replay(self, args):
        for static, a in zip(self.inputs, args):
            static.copy_(a)
        self.graph.replay()
        for key, n in self.launches.items():
            _cuda.launch_counts[key] += n
        return _map(torch.Tensor.clone, self.outputs)


class CapturedProgram:
    """``fn`` (tensors in, a dict of tensors out) as one program per input
    signature: a CUDA graph on the card, eager on the CPU (see the module
    docstring).  ``count`` is the number of signatures seen (the twin of the
    JAX ``trace_counts`` entry); ``source`` says how the last call ran:
    ``"captured"`` (first call of a signature on the card), ``"replayed"``
    or ``"eager"``; ``warm_ms`` and ``capture_ms`` time the last capture's
    warm-up call and the capture itself (host clock)."""

    def __init__(self, fn: Callable, name: str, pool: Optional[GraphPool] = None, capture: bool = True):
        self.fn = fn
        self.name = name
        self._pool = pool or GraphPool()
        self._capture = capture
        self._programs: Dict[tuple, Optional[_Graph]] = {}  # signature -> graph; None: runs eagerly
        self.source: Optional[str] = None
        self.warm_ms: Optional[float] = None
        self.capture_ms: Optional[float] = None

    @property
    def count(self) -> int:
        return len(self._programs)

    def __call__(self, *args):
        if getattr(_local, "eager", False):
            self.source = "eager"
            return self.fn(*args)
        sig = signature(args)
        if sig in self._programs:
            program = self._programs[sig]
            if program is None:
                self.source = "eager"
                return self.fn(*args)
            self.source = "replayed"
            return program.replay(args)
        if not self._captures(args):
            self._programs[sig] = None
            self.source = "eager"
            return self.fn(*args)
        out, self._programs[sig] = self._warm_and_capture(args)
        self.source = "captured"
        return out

    def _captures(self, args) -> bool:
        """Whether a new signature is captured: inputs on the card, and capture on."""
        devices = {a.device.type for a in args}
        if "cuda" in devices and len(devices) > 1:
            raise ValueError(f"{self.name}: inputs on {sorted(devices)}; a program runs on one device")
        return devices == {"cuda"} and self._capture

    def _warm_and_capture(self, args):
        dev = args[0].device
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.fn(*args)
        current.wait_stream(side)
        _map(lambda t: t.record_stream(current), out)  # the caller reads it on its stream
        torch.cuda.synchronize(dev)  # the capture below synchronises too; here it times the warm-up
        t1 = time.perf_counter()
        inputs = [a.clone() for a in args]  # outside the pool: never overwritten by another graph
        before = dict(_cuda.launch_counts)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool.handle(), capture_error_mode="thread_local"):
                outputs = self.fn(*inputs)
        finally:  # a capture launches nothing: what it counted is what each replay launches
            launches = {k: n - before.get(k, 0) for k, n in _cuda.launch_counts.items() if n != before.get(k, 0)}
            _cuda.launch_counts.clear()
            _cuda.launch_counts.update(before)
        self.warm_ms, self.capture_ms = (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3
        return out, _Graph(graph, inputs, outputs, launches)


class StepProgram(CapturedProgram):
    """A training step ``fn(*batch) -> {name: 0-d tensor}`` that writes the
    state of ``modules`` and ``optimizers`` in place, as one program per
    batch signature (see the module docstring).  On the card the first call
    of a signature is the warm-up step, run eagerly on a side stream, whose
    metrics it returns; the capture that follows leaves the state as the
    warm-up left it, and each later call replays one step.  After a
    capturing call the parameters' ``.grad`` are the graph's buffers,
    written at each replay.  The program owns its memory pool."""

    def __init__(self, fn: Callable, name: str, modules: Iterable[torch.nn.Module],
                 optimizers: Iterable[torch.optim.Optimizer], capture: bool = True):
        super().__init__(fn, name, GraphPool(), capture)
        ref = weakref.ref(self)

        def drop(*_):
            program = ref()
            if program is not None:
                program.drop()

        for module in modules:
            module.register_load_state_dict_post_hook(drop)
        for opt in optimizers:
            opt.register_load_state_dict_post_hook(drop)

    def drop(self) -> None:
        """Forget every signature's graph: the next call warms up and captures
        again, in a new pool (a pool whose graphs are all gone cannot take
        another capture)."""
        self._programs.clear()
        self._pool = GraphPool()
