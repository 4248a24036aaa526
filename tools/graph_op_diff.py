#!/usr/bin/env python3
"""Find the first op whose result differs between a codec program run eagerly
and the same program captured as a CUDA graph and replayed.

Builds the full-width codec (config/SimWhisperCodec.yaml, random weights from
a fixed seed) in ``--mode`` (default parity), then runs its tokenize and
detokenize functions on a batch of 8 x 30 s twice under a
``TorchDispatchMode`` that sums every floating aten op's output in float64:
twice eagerly, then once inside ``torch.cuda.graph`` (after a side-stream
warm-up, as ``utils/aot.py`` captures) and replayed.  Prints, per stage, the
number of ops, how many differ between the two eager runs (an op that does
not repeat itself), and the first ops whose sums differ between eager and
the replay (name, input shapes, both sums) and how many differ.  The sums are extra ops inside the graph; they read the
program's outputs and change none of them.

Run from the repository root on the machine with the GPU:
    python3 tools/graph_op_diff.py [--mode parity]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHOW = 8  # differing ops printed per stage


def op_sums(torch):
    """A dispatch mode that records (op, input shapes, f64 sum of the output) for every floating output."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Sums(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.rows = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in out if isinstance(out, (list, tuple)) else [out]:
                if isinstance(o, torch.Tensor) and o.is_floating_point() and o.numel():
                    shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
                    self.rows.append((str(func), shapes, o.detach().to(torch.float64).sum()))
            return out

    return Sums()


def differing(a, b) -> list:
    """Indices of the ops whose sums differ between two runs of the same op sequence."""
    return [i for i, (x, y) in enumerate(zip(a, b)) if x[0] == y[0] and x[2] != y[2]]


def diff(torch, name, fn, args, precision) -> int:
    """Eager against captured-and-replayed sums of ``fn(*args)``; returns the number of ops that differ."""
    from simwhisper_codec_tpu_torch.models.codec import f32_precision

    with torch.no_grad(), f32_precision(precision):
        eager, again = op_sums(torch), op_sums(torch)
        with eager:
            fn(*args)
        with again:
            fn(*args)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        static = [a.clone() for a in args]
        graph, replayed = torch.cuda.CUDAGraph(), op_sums(torch)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            with replayed:
                fn(*static)
        graph.replay()
        torch.cuda.synchronize()
    a = [(op, sh, float(v)) for op, sh, v in eager.rows]
    b = [(op, sh, float(v)) for op, sh, v in replayed.rows]
    repeat = differing(a, [(op, sh, float(v)) for op, sh, v in again.rows])
    print(f"[diff] {name}: {len(a)} eager ops, {len(b)} graph ops; eager against eager: {len(repeat)} ops differ"
          + (f", the first op {repeat[0]} {a[repeat[0]][0]} {a[repeat[0]][1]}" if repeat else ""), flush=True)
    n_diff = 0
    for i, (x, y) in enumerate(zip(a, b)):
        if x[0] != y[0]:
            print(f"[diff] {name}: the op sequences part at {i}: {x[0]} against {y[0]}", flush=True)
            break
        if x[2] != y[2]:
            n_diff += 1
            if n_diff <= SHOW:
                print(f"[diff] {name}: op {i} {x[0]} {x[1]}: eager sum {x[2]!r}, graph sum {y[2]!r}", flush=True)
    print(f"[diff] {name}: {n_diff} ops differ", flush=True)
    return n_diff


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="parity", help="AudioCodec mode")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("graph_op_diff: no CUDA device", file=sys.stderr)
        return 2
    from simwhisper_codec_tpu_torch.config import load_config
    from simwhisper_codec_tpu_torch.models.codec import AudioCodec, f32_precision, init_params

    cfg = load_config("config/SimWhisperCodec.yaml")
    codec = AudioCodec(cfg, init_params(cfg, torch.Generator().manual_seed(0)), batch_size=8, device="cuda",
                       mode=args.mode)
    wav = np.random.default_rng(0).standard_normal((8, cfg.chunk_samples)).astype(np.float32) * 0.1
    wav_t = torch.from_numpy(wav).cuda()
    lens = torch.full((8,), cfg.chunk_samples, device="cuda")
    diff(torch, f"{args.mode} tokenize", codec._tokenize.fn, [wav_t, lens], codec.precision)
    with torch.no_grad(), f32_precision(codec.precision):
        tok = codec._tokenize.fn(wav_t, lens)
    width = torch.full((), cfg.code_frames, dtype=torch.int32, device="cuda")
    diff(torch, f"{args.mode} detokenize", codec._detokenize.fn, [tok["codes"], tok["codes_lengths"], width],
         codec.precision)
    return 0


if __name__ == "__main__":
    sys.exit(main())
