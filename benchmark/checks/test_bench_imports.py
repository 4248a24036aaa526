"""What a run imports: never JAX nor the JAX package; the reference nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import ROOT

BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "simwhisper_codec_tpu"}


def loaded_top_level(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after ``code``."""
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True).stdout.split()
    return set(out)


def test_the_harness_and_the_port_it_drives_load_no_jax():
    code = ("import benchmark.run, benchmark.calibrate, benchmark.sweep, benchmark.loops.offline, "
            "benchmark.loops.http_open_loop\n"
            "from benchmark import cell\n"
            "for m in cell.load_manifest()['per_layer']: cell.metric_reader(m['name'])\n"
            "import simwhisper_codec_tpu_torch.serve, simwhisper_codec_tpu_torch.models.codec\n")
    names = loaded_top_level(code)
    assert "simwhisper_codec_tpu_torch" in names and not names & FORBIDDEN


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
    names = loaded_top_level("import benchmark.reference, benchmark.weights, benchmark.judge, benchmark.traffic, "
                             "benchmark.yardstick")
    assert not names & (FORBIDDEN | {"simwhisper_codec_tpu_torch"})


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py")))
def test_no_source_names_jax(path):
    tree = ast.parse((BENCH / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops = {node.module.split(".")[0]}
        else:
            continue
        assert not tops & FORBIDDEN, (path, tops)
        if Path(path).name in ("reference.py", "weights.py", "judge.py", "traffic.py", "yardstick.py"):
            assert "simwhisper_codec_tpu_torch" not in tops, (path, tops)
