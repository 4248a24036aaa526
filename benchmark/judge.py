"""The numbers that decide ``correct``, each against its limit.

- ``code_gap``: over every code frame of every checked utterance and every
  FSQ dimension, how far the level the program chose lies from the
  reference's value before rounding, beyond the half level that rounding
  allows (in level steps; 0 when every level is a correct rounding of the
  reference's value).  The widest gap, as for a served token's logit.
- ``wav_err``: the largest relative L2 error ||y - y_ref|| / ||y_ref|| of a
  checked utterance's waveform, the reference decoding the program's own
  codes at the chunk widths the program decoded them at.
- ``shape_errors``: outputs of the wrong shape, or not finite (limit 0).
- ``low_precision_launches``: launches, in the window's program calls, of
  hand kernels whose operands are in a format below the lowest that the
  configuration states for any stage of that program (limit 0).  It holds
  each cell to its configuration's precision where the outputs alone
  cannot: the program's own int8 path is within the bf16 cell's
  ``wav_err``, as is int8 tokenize within the int8 cells' ``code_gap``.
  A kernel's format is read from its launch key (``ln_ffn_int8:...``);
  library products (``torch._int_mm``) make no launch and are not seen.

The limits live in ``limits/<workload>.json`` with the readings they were
set from.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent


def level_indices(codes: np.ndarray, levels: Sequence[int]) -> np.ndarray:
    """Group indices (G, T) -> each dimension's level (T, G * len(levels))."""
    base = np.cumprod([1] + list(levels[:-1]))
    g, t = codes.shape
    per = (codes.T.astype(np.int64)[:, :, None] // base) % np.asarray(levels)
    return per.reshape(t, g * len(levels))


def code_gap(codes: np.ndarray, ref_levels: np.ndarray, levels: Sequence[int]) -> float:
    if codes.shape[1] == 0:
        return 0.0
    got = level_indices(codes, levels)
    return float(np.maximum(np.abs(ref_levels - got) - 0.5, 0.0).max())


def wav_err(y: np.ndarray, y_ref: np.ndarray) -> float:
    return float(np.linalg.norm(y.astype(np.float64) - y_ref) / max(np.linalg.norm(y_ref.astype(np.float64)), 1e-30))


def shape_error(got: np.ndarray, want_shape: Tuple[int, ...]) -> bool:
    return tuple(got.shape) != tuple(want_shape) or not np.isfinite(got).all()


# which program runs each stage that a configuration's ``precision`` names
STAGE_PROGRAM = {
    "mel_dft": "tokenize", "mel_filterbank": "tokenize", "encoder_convs": "tokenize",
    "encoder_transformer": "tokenize", "downsample": "tokenize",
    "upsample": "detokenize", "decoder_attention": "detokenize", "decoder_deconvs": "detokenize",
    "decoder_ffn": "detokenize", "vocos_embed": "detokenize", "vocos_depthwise": "detokenize",
    "vocos_pointwise": "detokenize", "vocos_head": "detokenize", "istft": "detokenize",
}
# operand formats, widest first: a larger rank is a lower precision
FORMAT_RANK = {"f32": 0, "tf32": 1, "bf16": 2, "fp16": 2, "fp8": 3, "int8": 3, "int4": 4}
# the format named in a launch key ("ln_ffn_int8:512x4096"); keys naming none are bf16 or wider
KEY_FORMATS = ("int4", "int8", "fp8")


def launch_format(key: str) -> str:
    name = key.split(":")[0]
    return next((f for f in KEY_FORMATS if f in name.split("_")), "bf16")


def low_precision_launches(program_calls: Sequence[dict], precision: Dict[str, str]) -> int:
    """Launches, over ``program_calls`` (``spans.Recorder.program_calls``), of kernels
    in a format below every format that ``precision`` states for the call's program."""
    lowest = {}
    for stage, fmt in precision.items():
        prog = STAGE_PROGRAM[stage]
        lowest[prog] = max(lowest.get(prog, 0), FORMAT_RANK[fmt])
    return sum(n for call in program_calls for key, n in call["launches"].items()
               if FORMAT_RANK[launch_format(key)] > lowest[call["direction"]])


def load_limits(workload: str) -> Dict[str, float]:
    with open(HERE / "limits" / f"{workload}.json") as f:
        return {k: float(v["limit"]) for k, v in json.load(f).items()}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(every number within its limit, {name: {"value", "limit"}}); a number
    that is missing or not finite fails."""
    checks = {name: {"value": numbers.get(name, math.nan), "limit": limit} for name, limit in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def check_lines(checks: Dict[str, dict]) -> List[str]:
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})" for name, c in checks.items()]
