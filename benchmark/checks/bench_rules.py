"""The benchmark's rules on its own files, as functions of a checkout's root.

Each returns the faults it finds, one line of text each: none where the tree
keeps the rule.  ``test_bench_manifest.py`` and ``test_bench_imports.py``
hold this repository to them; ``test_bench_rules.py`` holds a fixture tree
(the codec and a stand-in second model) to them, whole and with each fault
planted.

- Configurations: every file under ``configs/`` states ``model`` (a module
  ``benchmark/models/<model>.py`` with ``parameter_count(cfg)``,
  ``widths(cfg)`` and ``CUTTABLE``), ``parameters``, ``published`` (the
  source's depths and widths under the names ``widths`` returns),
  ``reduced`` and ``reference`` (the path of its plain reference module).
  ``parameters`` is the model's count; each published size is what
  ``widths`` reads unless ``reduced`` lists it, and each listed one differs
  and is one its model's ``CUTTABLE`` names (a depth or the chip's share,
  never a width); the manifest's ``reduced`` is the file's.  The models are
  read in a child process with the checkout's root first on the path, so
  that a model module's imports are the checkout's.
- Loops: every ``loops/*.py`` defines ``run(run)`` and
  ``controls(run, config, sides=None)`` (``calibrate.py`` refuses one whose
  sides hold no ``control``).
- Limits: each limit of each cell lies between its two readings, with more
  room above the lower.
- Imports: no loop, loaded beside the port, and no harness module loads JAX
  or the JAX package; no configuration's reference, with the yardstick
  modules and the models' modules, loads those or the program; no source
  names them, and the reference, yardstick and model sources name nothing
  of the program.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "simwhisper_codec_tpu"}
PROGRAM = "simwhisper_codec_tpu_torch"
CONFIG_KEYS = {"model", "parameters", "published", "reduced", "reference"}
YARDSTICK = ("weights", "judge", "traffic", "yardstick")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def configs(root: Path) -> List[tuple]:
    """(manifest entry, configuration file) of every configuration."""
    return [(c, load_json(root / c["file"])) for c in manifest(root)["configs"]]


def _child(root: Path, body: str, path: List[Path], **consts) -> dict:
    """Run ``body`` in a fresh interpreter in ``root`` with ``path`` first on
    ``sys.path`` and each of ``consts`` bound from JSON; the JSON of its last
    line (``{"error": ...}`` if the child fails)."""
    code = (f"import importlib, json, sys\nsys.path[:0] = {[str(p) for p in path]!r}\n"
            + "".join(f"{k} = json.loads({json.dumps(v)!r})\n" for k, v in consts.items()) + body)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        return {"error": proc.stderr[-2000:]}
    return json.loads(proc.stdout.strip().splitlines()[-1])


def reference_module(root: Path, path: str) -> Optional[str]:
    """``benchmark/<...>.py`` -> ``benchmark.<...>``; None for a path that is no module file under ``benchmark/``."""
    ok = path.startswith("benchmark/") and path.endswith(".py") and ".." not in path and (root / path).is_file()
    return path[:-3].replace("/", ".") if ok else None


_MODELS = """
out = []
for model, cfg in ITEMS:
    m = importlib.import_module('benchmark.models.' + model)
    out.append({'parameters': m.parameter_count(cfg), 'widths': m.widths(cfg), 'cuttable': sorted(m.CUTTABLE)})
print(json.dumps(out))
"""


def model_readings(root: Path, items: List[tuple]) -> List[dict]:
    """For each (model, configuration): its model's ``parameters``, ``widths``
    and ``cuttable``, read in the checkout at ``root`` (``[{"error": ...}]``
    if the child fails)."""
    out = _child(root, _MODELS, [root], ITEMS=items)
    return [out] * len(items) if "error" in out else out


def config_faults(root: Path) -> List[str]:
    faults, stated = [], []
    for entry, cfg in configs(root):
        missing = CONFIG_KEYS - set(cfg)
        if missing:
            faults.append(f"{entry['name']}: the file states no {sorted(missing)}")
        else:
            stated.append((entry, cfg))
    readings = model_readings(root, [(cfg["model"], cfg) for _, cfg in stated])
    for (entry, cfg), model in zip(stated, readings):
        name = entry["name"]
        if "error" in model:
            faults.append(f"{name}: its model {cfg['model']!r} could not be read: {model['error']}")
            continue
        if cfg["parameters"] != model["parameters"]:
            faults.append(f"{name}: states {cfg['parameters']} parameters, its model counts {model['parameters']}")
        widths, published, reduced = model["widths"], cfg["published"], cfg["reduced"]
        if set(widths) != set(published):
            faults.append(f"{name}: published names {sorted(published)}, the model's widths {sorted(widths)}")
        for key in sorted(set(widths) & set(published)):
            if key in reduced and widths[key] == published[key]:
                faults.append(f"{name}: {key} is listed in reduced but is the published {published[key]}")
            elif key not in reduced and widths[key] != published[key]:
                faults.append(f"{name}: {key} is {widths[key]}, published {published[key]}, and not in reduced")
        faults += [f"{name}: reduced names {key}, no published size" for key in reduced if key not in published]
        faults += [f"{name}: reduced names {key}, which its model does not let be cut ({model['cuttable']})"
                   for key in reduced if key in published and key not in model["cuttable"]]
        if entry["reduced"] != reduced:
            faults.append(f"{name}: BENCHMARK.json reduces {entry['reduced']}, the file {reduced}")
        if reference_module(root, cfg["reference"]) is None:
            faults.append(f"{name}: its reference {cfg['reference']!r} is no module file under benchmark/")
    return faults


def limit_faults(root: Path, workload: str) -> List[str]:
    path = root / "benchmark" / "limits" / f"{workload}.json"
    if not path.is_file():
        return [f"{workload}: no limits file"]
    faults = []
    for name, entry in load_json(path).items():
        lo, lim, up = entry.get("lower"), entry["limit"], entry.get("upper")
        if lim == 0.0:  # exact: sound runs read 0, and a control, where one was read, more
            ok = (lo is None or lo == 0.0) and (up is None or up > 0.0)
        else:  # with more room above the lower reading than below the upper
            ok = lo is not None and up is not None and lo < lim < up and up >= 3 * lo and lim - lo > up - lim
        if not ok:
            faults.append(f"{workload}: {name} limit {lim} against lower {lo}, upper {up}")
    return faults


def loop_names(root: Path) -> List[str]:
    return sorted(p.stem for p in (root / "benchmark" / "loops").glob("*.py") if p.stem != "__init__")


LOOP_FUNCTIONS = {"run": ["run"], "controls": ["run", "config", "sides"]}


def loop_protocol_faults(root: Path) -> List[str]:
    """Every loop defines ``run(run)`` and ``controls(run, config, sides=None)``."""
    faults = []
    for name in loop_names(root):
        tree = ast.parse((root / "benchmark" / "loops" / f"{name}.py").read_text())
        defs = {n.name: [a.arg for a in n.args.args] for n in tree.body if isinstance(n, ast.FunctionDef)}
        faults += [f"loops/{name}.py defines no {fn}({', '.join(args)})"
                   for fn, args in LOOP_FUNCTIONS.items() if defs.get(fn) != args]
    return faults


_LOADS = """
def tops():
    return {m.split('.')[0] for m in list(sys.modules)}
forbidden = set(FORBIDDEN)
out = {}
for name in BASE:
    importlib.import_module(name)
exec(SETUP)
seen = tops()
out['base'] = sorted(seen & forbidden)
for name in NAMES:
    try:
        importlib.import_module(name)
    except Exception as e:  # a module that fails to import fails the rule
        out[name] = ['{}: {}'.format(type(e).__name__, e)]
        continue
    now = tops()
    out[name] = sorted((now - seen) & forbidden)
    seen = now
out['loaded'] = sorted(seen)
print(json.dumps(out))
"""


def _loads(root: Path, base: List[str], names: List[str], forbidden: set, setup: str = "") -> dict:
    """In a fresh interpreter with ``root``, then the repository (for the
    port), first on the path: ``base`` imported and ``setup`` run, then each
    of ``names``; the ``forbidden`` top-level names each step added, and
    every top-level name loaded (``{"error": ...}`` if the child fails)."""
    return _child(root, _LOADS, [root, REPO], FORBIDDEN=sorted(forbidden), BASE=base, NAMES=names, SETUP=setup)


def loop_import_faults(root: Path) -> List[str]:
    """Every loop, imported beside the port and the harness (every metric
    reader loaded too), loads no JAX and no JAX package; ``base`` in a fault
    is the port and the harness before any loop."""
    base = [f"{PROGRAM}.serve", f"{PROGRAM}.models.codec", "benchmark.run", "benchmark.calibrate",
            "benchmark.sweep", "benchmark.cell"]
    readers = "from benchmark import cell\n" + "".join(
        f"cell.metric_reader({m['name']!r})\n" for m in manifest(root)["per_layer"])
    out = _loads(root, base, [f"benchmark.loops.{n}" for n in loop_names(root)], FORBIDDEN, readers)
    if "error" in out:
        return [f"the loops' child failed: {out['error']}"]
    faults = [f"{name} loads {found}" for name, found in out.items() if name != "loaded" and found]
    if PROGRAM not in out["loaded"]:
        faults.append("the port was not loaded beside the loops")
    return faults


def reference_import_faults(root: Path) -> List[str]:
    """Each configuration's reference, loaded with the yardstick modules and
    the models' modules, loads no JAX, no JAX package and nothing of the program."""
    faults = []
    models = sorted({cfg["model"] for _, cfg in configs(root) if "model" in cfg})
    base = [f"benchmark.{m}" for m in YARDSTICK] + [f"benchmark.models.{m}" for m in models]
    for path in sorted({cfg["reference"] for _, cfg in configs(root) if "reference" in cfg}):
        module = reference_module(root, path)
        if module is None:
            faults.append(f"{path}: no module file under benchmark/")
            continue
        out = _loads(root, base, [module], FORBIDDEN | {PROGRAM})
        if "error" in out:
            faults.append(f"{path}: its child failed: {out['error']}")
        else:
            faults += [f"{path}: {'the yardstick and model modules' if name == 'base' else name} load {found}"
                       for name, found in out.items() if name != "loaded" and found]
    return faults


def program_free_sources(root: Path) -> set:
    """Sources that may import nothing of the program: the yardstick modules,
    the models' modules, each configuration's reference, any ``reference.py``."""
    bench = root / "benchmark"
    paths = {bench / f"{m}.py" for m in YARDSTICK} | set((bench / "models").glob("*.py"))
    paths |= {root / cfg["reference"] for _, cfg in configs(root) if "reference" in cfg}
    paths |= set(bench.rglob("reference.py"))
    return {p.resolve() for p in paths}


def imported_tops(source: str) -> set:
    tops = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def source_faults(root: Path, path: Path) -> List[str]:
    """The imports written in one source of the benchmark."""
    tops = imported_tops(path.read_text())
    faults = [f"{path.relative_to(root)} imports {sorted(tops & FORBIDDEN)}"] if tops & FORBIDDEN else []
    if PROGRAM in tops and path.resolve() in program_free_sources(root):
        faults.append(f"{path.relative_to(root)} imports the program")
    return faults
