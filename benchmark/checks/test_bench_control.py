"""The controls come out not correct.

The control, the reference in the program's place one format lower (the
``control`` side of the loop's controls, as ``calibrate.py`` reads them):
on the card at every cell's own size (``-m chip``) against its limits, on
the checked answers of a short run, three seeds each; on the CPU at narrow
widths, for the codec's cells, apart from the program by three times or
more.  The program's own lower-precision path (the configuration's
``program_control``), for every cell whose configuration has one, on the
card at the cell's size, three seeds each; on the CPU the count the codec's
fail on is checked on launch records.
"""

import importlib

import pytest
import torch

from benchmark import cell, judge
from tiny import tiny_run

CODEC_WORKLOADS = ["codec-int8.offline-long", "codec-bf16.offline-long", "codec-int8.serve-short"]
MANIFEST = cell.load_manifest()
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]
LOWER_PATH_WORKLOADS = [w["name"] for w in MANIFEST["workloads"]
                        if "program_control" in cell.config_file(MANIFEST, w["config"])]


def control_numbers(run):
    loop = importlib.import_module(f"benchmark.loops.{run.mix['loop']}")
    loop.run(run)
    return loop.controls(run, run.config, sides=["control"])["control"]


@pytest.mark.parametrize("workload", CODEC_WORKLOADS)
def test_control_separates_from_the_program_at_narrow_widths(workload):
    """At narrow widths the errors are not the cells' (two layers a tower, three
    Vocos blocks), so the cells' limits are held on the card below; here the
    control reads at least three times what the program reads on some number,
    as the limits' readings need."""
    _, run = tiny_run(workload, seed=2**31 + 901, seconds=2.0)
    control = control_numbers(run)
    assert any(control[k] >= 3 * run.numbers[k] > 0 for k in ("code_gap", "wav_err")), (control, run.numbers)


def cell_run(workload, seed, device, program_control=False):
    import tempfile
    import time

    from benchmark.run import CACHE

    wl = cell.workload_entry(MANIFEST, workload)
    config = cell.config_file(MANIFEST, wl["config"])
    if program_control:
        config = dict(config, **config["program_control"])
    return cell.Run(workload=workload, seed=seed, seconds=3.0, trace=False, wl=wl, config=config,
                    mix=cell.mix_file(wl["traffic"]), device=device, tmpdir=tempfile.gettempdir(),
                    aot_dir=CACHE / "benchmark", t_start=time.time())


@pytest.mark.chip
@pytest.mark.parametrize("seed", [2**31 + 1001, 2**31 + 1002, 2**31 + 1003])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_at_the_cells_size(chip, workload, seed):
    ok, checks = judge.verdict(control_numbers(cell_run(workload, seed, chip)), judge.load_limits(workload))
    assert not ok, checks
    torch.cuda.empty_cache()


@pytest.mark.chip
@pytest.mark.parametrize("seed", [2**31 + 1011, 2**31 + 1012, 2**31 + 1013])
@pytest.mark.parametrize("workload", LOWER_PATH_WORKLOADS)
def test_program_lower_path_fails_at_the_cells_size(chip, workload, seed):
    run = cell_run(workload, seed, chip, program_control=True)
    importlib.import_module(f"benchmark.loops.{run.mix['loop']}").run(run)
    ok, checks = judge.verdict(run.numbers, judge.load_limits(workload))
    assert not ok, checks
    if "low_precision_launches" in checks:  # the codec's lower paths fail on it alone
        assert checks["low_precision_launches"]["value"] > 0, checks
    torch.cuda.empty_cache()


def calls(direction, **launches):
    return [{"direction": direction, "launches": {k.replace("__", ":"): n for k, n in launches.items()}}]


BF16 = {"encoder_transformer": "bf16", "decoder_ffn": "bf16", "vocos_pointwise": "bf16", "istft": "tf32"}
INT8 = dict(BF16, decoder_ffn="int8", vocos_pointwise="int8")


@pytest.mark.parametrize("precision, records, want", [
    (BF16, calls("detokenize", ln_ffn_bf16__512x4096=24, pflash__x=12), 0),
    (BF16, calls("detokenize", ln_ffn_int8__512x4096=24, ln_ffn_bf16__768x3072=12), 24),
    (BF16, calls("tokenize", ln_ffn_int8_partial__768x1536=12), 12),
    (INT8, calls("detokenize", ln_ffn_int8__512x4096=24, ln_ffn_int8__768x3072=12), 0),
    (INT8, calls("tokenize", ln_ffn_int8__768x3072=12, ln_ffn_bf16__768x3072=0), 12),
    (INT8, calls("detokenize", ln_ffn_int4__512x4096=24), 24),
    (INT8, calls("tokenize", ln_ffn_bf16__768x3072=12) + calls("detokenize", ln_ffn_fp8__512x4096=3), 0),
])
def test_low_precision_launches_counts_formats_below_the_configuration(precision, records, want):
    assert judge.low_precision_launches(records, precision) == want
