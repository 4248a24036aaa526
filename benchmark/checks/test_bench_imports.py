"""What a run imports: never JAX nor the JAX package; the references nothing of the program."""

import sys

import bench_rules
import pytest

from conftest import ROOT

BENCH = ROOT / "benchmark"


def test_the_harness_and_the_port_it_drives_load_no_jax():
    """Every loop under ``loops/``, beside the port, the harness and the metric readers."""
    assert bench_rules.loop_import_faults(ROOT) == []


def test_the_run_compares_whole_top_level_names():
    """The port's name begins with the JAX package's: only a whole name counts."""
    import simwhisper_codec_tpu_torch.config  # noqa: F401
    from benchmark.run import forbidden_modules

    assert "simwhisper_codec_tpu" not in forbidden_modules()
    sys.modules["jax.fake_probe"] = sys
    try:
        assert forbidden_modules() == ["jax"]
    finally:
        del sys.modules["jax.fake_probe"]


def test_the_reference_imports_nothing_of_the_program():
    """Every configuration's reference, with the yardstick and model modules."""
    assert bench_rules.reference_import_faults(ROOT) == []


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py")))
def test_no_source_names_jax(path):
    """Nor a reference, yardstick or model source the program."""
    assert bench_rules.source_faults(ROOT, BENCH / path) == []
