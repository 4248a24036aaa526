"""A run with the timed path broken underneath comes out not correct.

Each fault is planted in the program's own stage functions
(``models.codec.tokenize`` / ``detokenize``, which both serving programs
run), and the rest of a run is driven as ``run.py`` drives it, on the CPU at
narrow widths, against the cells' own limits: an answer altered where it is
produced (one code frame of every row; every waveform a sample late) and
half of each batch left out (``AudioCodec.inference_tokenize`` /
``inference_detokenize`` giving the rows past the first half the first
half's results).
The unbroken run comes out correct.
"""

import pytest
import torch

from benchmark import judge
from tiny import tiny_run


def codes_altered(fn):
    def broken(*args, **kw):
        out = fn(*args, **kw)
        codes = out["codes"].clone()
        codes[:, :, 5] = (codes[:, :, 5] + 1000) % 2016
        return dict(out, codes=codes)
    return broken


def waveform_late(fn):
    def broken(*args, **kw):
        out = fn(*args, **kw)
        return dict(out, y=torch.roll(out["y"], 1, dims=1))
    return broken


def half_batch(fn):
    """Rows past the first half of the rows a call carries get the first half's results."""
    def broken(self, *args, **kw):
        out = fn(self, *args, **kw)
        b = out["codes"].shape[1] if "codes" in out else out["y"].shape[0]
        rows = torch.arange(b) % ((b + 1) // 2)
        return {k: (v[:, rows] if k == "codes" else v[rows]) for k, v in out.items()}
    return broken


FAULTS = {"codes_altered": ("tokenize", codes_altered), "waveform_late": ("detokenize", waveform_late),
          "half_batch_tokenize": ("AudioCodec.inference_tokenize", half_batch),
          "half_batch_detokenize": ("AudioCodec.inference_detokenize", half_batch)}
# every row position checked offline; every answer served, in micro-batches of several requests (a 1 s window), so that half a batch is a request
CELLS = {"offline": ("codec-int8.offline-long", {}),
         "serve": ("codec-int8.serve-short", {"check_per_kind": 16, "rate_per_s": 8.0, "server_flags": [
             "--max_batch", "8", "--window_ms", "1000", "--queue_depth", "64"]})}


def drive(cell_key, seed, monkeypatch, fault=None):
    import importlib

    from simwhisper_codec_tpu_torch.models import codec as codec_mod

    if fault is not None:
        where, wrap = FAULTS[fault]
        owner = codec_mod
        *path, name = where.split(".")
        for part in path:
            owner = getattr(owner, part)
        monkeypatch.setattr(owner, name, wrap(getattr(owner, name)))
    workload, changes = CELLS[cell_key]
    _, run = tiny_run(workload, seed=seed, seconds=2.0, **changes)
    importlib.import_module(f"benchmark.loops.{run.mix['loop']}").run(run)
    return judge.verdict(run.numbers, judge.load_limits(workload))


@pytest.mark.parametrize("cell_key", sorted(CELLS))
def test_unbroken_run_is_correct(cell_key, monkeypatch):
    ok, checks = drive(cell_key, 2**31 + 77, monkeypatch)
    assert ok, checks


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell_key", sorted(CELLS))
def test_broken_run_is_not_correct(cell_key, fault, monkeypatch):
    ok, checks = drive(cell_key, 2**31 + 77, monkeypatch, fault)
    assert not ok, checks
