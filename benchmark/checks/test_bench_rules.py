"""The rules hold a tree with a second model, and refuse each fault planted in it.

The fixture tree (``fixture_tree.py``) is this benchmark's files with a
stand-in second model, cut in depth, added by new files and entries only.
Whole, it keeps every rule of ``bench_rules.py``; each planted fault is
refused by the rule named beside it.  ``calibrate.py`` prints the sides of
the stand-in loop's ``controls``, and refuses controls without a ``control``
side.
"""

import json
import os
import subprocess
import sys

import bench_rules
import fixture_tree
import pytest


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return fixture_tree.build(tmp_path_factory.mktemp("tree"))


def source_faults(root):
    return [f for path in sorted((root / "benchmark").rglob("*.py")) for f in bench_rules.source_faults(root, path)]


def all_faults(root):
    """Every rule's faults over the tree at ``root``."""
    faults = (bench_rules.config_faults(root) + bench_rules.loop_protocol_faults(root)
              + bench_rules.loop_import_faults(root) + bench_rules.reference_import_faults(root)
              + source_faults(root))
    for w in bench_rules.manifest(root)["workloads"]:
        faults += bench_rules.limit_faults(root, w["name"])
    return faults


def test_the_tree_with_a_second_model_keeps_every_rule(tree):
    assert [w["name"] for w in bench_rules.manifest(tree)["workloads"]][-1] == "stand-in.cell"
    assert all_faults(tree) == []


FAULTS = {
    "wrong_parameter_count": (fixture_tree.plant_wrong_parameter_count, bench_rules.config_faults),
    "width_changed_unlisted": (fixture_tree.plant_width_changed_unlisted, bench_rules.config_faults),
    "listed_but_unchanged": (fixture_tree.plant_listed_but_unchanged, bench_rules.config_faults),
    "width_reduced": (fixture_tree.plant_width_reduced, bench_rules.config_faults),
    "manifest_reduced_differs": (fixture_tree.plant_manifest_reduced_differs, bench_rules.config_faults),
    "limit_outside_readings": (fixture_tree.plant_limit_outside_readings,
                               lambda root: bench_rules.limit_faults(root, "stand-in.cell")),
    "loop_without_controls": (fixture_tree.plant_loop_without_controls, bench_rules.loop_protocol_faults),
    "loop_imports_jax": (fixture_tree.plant_loop_imports_jax, bench_rules.loop_import_faults),
    "loop_imports_jax_written": (fixture_tree.plant_loop_imports_jax, source_faults),
    "loop_loads_jax_unwritten": (fixture_tree.plant_loop_loads_jax_unwritten, bench_rules.loop_import_faults),
    "reference_imports_port": (fixture_tree.plant_reference_imports_port, bench_rules.reference_import_faults),
    "reference_imports_port_written": (fixture_tree.plant_reference_imports_port, source_faults),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_planted_fault_is_refused(fault, tmp_path):
    plant, rule = FAULTS[fault]
    root = fixture_tree.build(tmp_path)
    plant(root)
    faults = rule(root)
    assert faults and all("stand" in f for f in faults), faults


def calibrate(root):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "benchmark/calibrate.py", "--workload", "stand-in.cell", "--seeds", "3",
                           "--control_seeds", "4", "--seconds", "0.5"], cwd=root, env=env, capture_output=True,
                          text=True, timeout=300)


def test_calibrate_prints_the_sides_of_a_loops_controls(tree):
    proc = calibrate(tree)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [(line["seed"], line["side"]) for line in lines] == [
        (3, "program"), (4, "program"), (4, "control"), (4, "control.weights"), (4, "program_control")]
    limit = json.loads((tree / "benchmark" / "limits" / "stand-in.cell.json").read_text())["err"]["limit"]
    sides = {line["side"]: line["err"] for line in lines if line["seed"] == 4}
    assert sides["program"] < limit < min(sides["control"], sides["control.weights"], sides["program_control"]), sides
    assert lines[-1]["mode"] == "lower"


def test_calibrate_refuses_controls_without_a_control_side(tmp_path):
    root = fixture_tree.build(tmp_path)
    fixture_tree.plant_controls_without_a_control_side(root)
    proc = calibrate(root)
    assert proc.returncode != 0 and "no control side" in proc.stderr, proc.stderr[-3000:]
    assert [json.loads(line)["side"] for line in proc.stdout.splitlines()] == ["program", "program"]
