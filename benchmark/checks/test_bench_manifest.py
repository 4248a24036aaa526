"""BENCHMARK.json against the benchmark contract's form: names, units, files, entries."""

import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def manifest():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys_and_sizes():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(m["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in m["paths"])
    assert 1 <= len(m["command"]) <= 32 and all(1 <= len(w) <= 200 and "\t" not in w for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43200 s
    assert 2 + 14 * 24 <= (43200 - 1200 - 24 * 180) / (m["run_seconds"] + 60)


def test_names_units_and_text_use_the_allowed_characters():
    m = manifest()
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in m[key]]
    assert all(NAME.match(n) for n in names), names
    assert len(names) == len(set(names))
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in m["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_entries_have_just_the_contract_keys():
    m = manifest()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_one():
    m = manifest()
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in m["workloads"]:
        reported = {n for n, e in e2e.items() if "workloads" not in e or w["name"] in e["workloads"]}
        assert "setup_s" in reported and len(reported) >= 2
        layer = [p for p in m["per_layer"] if w["name"] in p.get("workloads", [])]
        assert layer and all(p["moves"] in reported for p in layer)
    for p in m["per_layer"]:
        assert p["moves"] in e2e and p["moves"] != "setup_s"


def test_files_are_found_by_name_under_paths():
    m = manifest()
    root = ROOT / m["paths"][0]
    for c in m["configs"]:
        assert c["file"].startswith(m["paths"][0] + "/") and (ROOT / c["file"]).is_file()
    for w in m["workloads"]:
        assert (root / "mixes" / f"{w['traffic']}.json").is_file()
        assert (root / "limits" / f"{w['name']}.json").is_file()
    for p in m["per_layer"]:
        assert (root / "metrics" / f"{p['name']}.py").is_file()


def test_configs_are_the_published_generator_uncut():
    from benchmark.weights import parameter_count

    m = manifest()
    for c in m["configs"]:
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert c["reduced"] == [] == cfg["reduced"]
        assert parameter_count(cfg["generator_params"]) == cfg["parameters"] == 291315186
        gp = cfg["generator_params"]
        assert (gp["acoustic_encoder"]["encoder_layers"], gp["acoustic_encoder"]["d_model"],
                gp["acoustic_encoder"]["encoder_ffn_dim"], gp["vocos"]["num_layers"],
                gp["vocos"]["intermediate_dim"]) == (12, 768, 3072, 24, 4096)


@pytest.mark.parametrize("workload", ["codec-int8.offline-long", "codec-bf16.offline-long", "codec-int8.serve-short"])
def test_limits_lie_between_their_readings(workload):
    with open(ROOT / "benchmark" / "limits" / f"{workload}.json") as f:
        limits = json.load(f)
    for name, entry in limits.items():
        if entry["limit"] == 0.0:  # exact: sound runs read 0, and a control, where one was read, more
            assert entry.get("lower", 0.0) == 0.0 and entry.get("upper", 1.0) > 0.0, name
        else:  # with more room above the lower reading than below the upper
            lo, lim, up = entry["lower"], entry["limit"], entry["upper"]
            assert lo < lim < up and up >= 3 * lo and lim - lo > up - lim, name
