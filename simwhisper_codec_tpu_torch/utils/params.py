"""Parameter accounting (a copy of the JAX package's ``utils/params.py``;
reference ``utils/helpers.py:12-51`` count_params_by_module), counting the
tensors of a module's ``state_dict`` (buffers such as the spectral-norm
vectors included, as the JAX tree holds them)."""

from __future__ import annotations

from typing import Dict

from torch import nn


def count_params_by_module(model: nn.Module) -> Dict[str, int]:
    """Elements per top-level child module, plus 'total'."""
    out: Dict[str, int] = {}
    for key, t in model.state_dict().items():
        top = key.split(".", 1)[0]
        out[top] = out.get(top, 0) + t.numel()
    out["total"] = sum(out.values())
    return out


def format_param_report(model: nn.Module) -> str:
    counts = count_params_by_module(model)
    total = counts.pop("total")
    lines = [f"{'module':<16}{'params':>14}"]
    for k in sorted(counts, key=lambda k: -counts[k]):
        lines.append(f"{k:<16}{counts[k]:>14,}")
    lines.append(f"{'total':<16}{total:>14,}")
    return "\n".join(lines)
