"""A checkout for the rules' own checks: this benchmark's files and a stand-in second model.

``build(dst)`` copies ``BENCHMARK.json`` and ``benchmark/`` (the codec's
configurations, cells, loops and reference) and adds, as a later PR that
brings another model adds them, only new files and new entries:

- ``models/stand_in.py``: a transformer's parameter count and widths, its
  depth the one size it lets be cut;
- ``configs/stand-in.json``: 24 published layers cut to 4 (``reduced``
  lists ``num_hidden_layers``), the widths as published;
- ``stand_in_reference.py``: its plain reference (numpy);
- ``loops/stand_in.py``, ``mixes/stand-in.json``, ``limits/stand-in.cell.json``:
  a loop that runs the reference on the host and gives its controls'
  sides through ``controls(run, config, sides=None)``;
- the configuration and the cell ``stand-in.cell`` in ``BENCHMARK.json``.

The tree keeps every rule; each ``plant_*`` function breaks one.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from bench_rules import REPO

PUBLISHED = {"num_hidden_layers": 24, "hidden_size": 1024, "intermediate_size": 4096, "num_attention_heads": 16}

MODEL = '''"""A pre-LN transformer's size, read from a configuration's ``sizes``."""

CUTTABLE = {"num_hidden_layers"}


def parameter_count(cfg):
    s = cfg["sizes"]
    h, f = s["hidden_size"], s["intermediate_size"]
    return s["num_hidden_layers"] * (4 * h * h + 4 * h + 2 * h * f + f + h + 4 * h)


def widths(cfg):
    return {k: cfg["sizes"][k] for k in ("num_hidden_layers", "hidden_size", "intermediate_size",
                                          "num_attention_heads")}
'''

REFERENCE = '''"""The stand-in's plain reference: one product and a ReLU, in float64."""

import numpy as np


def forward(x, w):
    return np.maximum(x.astype(np.float64) @ w.astype(np.float64), 0.0)
'''

LOOP = '''"""The stand-in's loop: the reference on the host as the program, one format lower as its controls."""

import numpy as np

from benchmark import stand_in_reference as reference


def inputs(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((8, 16)), rng.standard_normal((16, 16))


def err(y, x, w):
    return float(np.abs(y - reference.forward(x, w)).max())


def run(run):
    x, w = inputs(run.seed)
    dtype = np.float16 if run.config.get("mode") == "lower" else np.float32
    y = reference.forward(x.astype(dtype), w.astype(dtype))
    run.setup_s, run.attempted, run.failed = 0.0, 1, 0
    run.end_to_end = {"rows_per_s": 8.0 / run.seconds}
    run.numbers = {"err": err(y, x, w)}


def controls(run, config, sides=None):
    x, w = inputs(run.seed)
    lower = {"control": (x.astype(np.float16), w.astype(np.float16)), "control.weights": (x, w.astype(np.float16))}
    return {side: {"err": err(reference.forward(*xw), x, w)} for side, xw in lower.items()
            if sides is None or side in sides}
'''

CONFIG = {
    "name": "stand-in", "source": "a stand-in for a second model's published configuration",
    "model": "stand_in", "reference": "benchmark/stand_in_reference.py", "parameters": 0,
    "published": PUBLISHED, "reduced": ["num_hidden_layers"], "sizes": dict(PUBLISHED, num_hidden_layers=4),
    "program_control": {"mode": "lower"},
}
# program (float32) 3.8e-7 to 5.4e-7 over seeds 0-4; controls (float16 operands, weights alone) from 1.1e-3
LIMITS = {"err": {"limit": 8e-4, "lower": 5.4e-7, "upper": 1.1e-3, "set_from": "the stand-in's readings"}}


def write_json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def build(dst: Path) -> Path:
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", dst / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "checks"))
    bench = dst / "benchmark"
    (bench / "models" / "stand_in.py").write_text(MODEL)
    (bench / "stand_in_reference.py").write_text(REFERENCE)
    (bench / "loops" / "stand_in.py").write_text(LOOP)
    write_json(bench / "mixes" / "stand-in.json", {"loop": "stand_in"})
    write_json(bench / "limits" / "stand-in.cell.json", LIMITS)
    model = {}
    exec(MODEL, model)
    config = dict(CONFIG, parameters=model["parameter_count"](CONFIG))
    write_json(bench / "configs" / "stand-in.json", config)
    manifest = json.loads((dst / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "stand-in", "source": config["source"], "reduced": ["num_hidden_layers"],
                                "file": "benchmark/configs/stand-in.json", "why": "a second model, cut in depth"})
    manifest["workloads"].append({"name": "stand-in.cell", "config": "stand-in", "traffic": "stand-in", "chips": 1,
                                  "why": "the stand-in's one cell"})
    write_json(dst / "BENCHMARK.json", manifest)
    return dst


def edit_json(path: Path, change) -> None:
    obj = json.loads(path.read_text())
    change(obj)
    write_json(path, obj)


def config_path(root: Path) -> Path:
    return root / "benchmark" / "configs" / "stand-in.json"


def plant_wrong_parameter_count(root: Path) -> None:
    edit_json(config_path(root), lambda c: c.update(parameters=c["parameters"] + 1))


def plant_width_changed_unlisted(root: Path) -> None:
    edit_json(config_path(root), lambda c: c["sizes"].update(hidden_size=768))


def plant_listed_but_unchanged(root: Path) -> None:
    edit_json(config_path(root), lambda c: c["sizes"].update(num_hidden_layers=24))


def plant_width_reduced(root: Path) -> None:
    def change(c):
        c["sizes"]["intermediate_size"] = 2048
        c["reduced"].append("intermediate_size")
    edit_json(config_path(root), change)
    edit_json(root / "BENCHMARK.json", lambda m: m["configs"][-1]["reduced"].append("intermediate_size"))


def plant_manifest_reduced_differs(root: Path) -> None:
    edit_json(root / "BENCHMARK.json", lambda m: m["configs"][-1].update(reduced=[]))


def plant_limit_outside_readings(root: Path) -> None:
    edit_json(root / "benchmark" / "limits" / "stand-in.cell.json", lambda lim: lim["err"].update(limit=0.05))


def plant_loop_imports_jax(root: Path) -> None:
    path = root / "benchmark" / "loops" / "stand_in.py"
    path.write_text(path.read_text().replace("import numpy as np\n", "import jax\nimport numpy as np\n", 1))


def plant_loop_loads_jax_unwritten(root: Path) -> None:
    """Loaded at run time, by a name no import statement holds."""
    path = root / "benchmark" / "loops" / "stand_in.py"
    path.write_text(path.read_text() + "\n__import__('importlib').import_module('ja' + 'x')\n")


def plant_loop_without_controls(root: Path) -> None:
    path = root / "benchmark" / "loops" / "stand_in.py"
    path.write_text(path.read_text().replace("def controls(run, config, sides=None):", "def sides(run, config):"))


def plant_controls_without_a_control_side(root: Path) -> None:
    path = root / "benchmark" / "loops" / "stand_in.py"
    path.write_text(path.read_text().replace('{"control": (', '{"lower": ('))


def plant_reference_imports_port(root: Path) -> None:
    path = root / "benchmark" / "stand_in_reference.py"
    path.write_text(path.read_text().replace("import numpy as np\n",
                                             "import numpy as np\nimport simwhisper_codec_tpu_torch.config\n", 1))
