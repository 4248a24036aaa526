"""Data parallelism over ``torch.distributed``.

Counterpart of the data-parallel half of ``simwhisper_codec_tpu/parallel/
mesh.py`` (the ``data`` mesh axis: batch rows sharded, parameters
replicated, gradients all-reduced).  One process a device, started by
``torchrun``: rank, world size and local rank come from its environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``),
with NCCL on ``cuda`` and gloo on ``cpu``.  Without that environment the
world is one process and no group exists, as the JAX package's one-device
case.

Gradients are averaged explicitly after each backward (``average_grads``),
not through DDP: a GAN step runs two backward passes on two models, and the
codec's encoder is frozen.  Each rank's loss is the mean over its rows, so
with equal shards the average of the ranks' gradients is the full batch's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterable, List

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DistContext:
    """Where this process stands; ``grouped`` is true when a process group exists
    (its collectives run even at world size 1)."""

    rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    grouped: bool = False

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` (a multiple of the world size)."""
        if n % self.world_size:
            raise ValueError(f"batch {n} is not a multiple of the world size {self.world_size}")
        per = n // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)


def current() -> DistContext:
    """The context of the initialised process group, else a world of one."""
    if not (dist.is_available() and dist.is_initialized()):
        return DistContext()
    return DistContext(dist.get_rank(), dist.get_world_size(), int(os.environ.get("LOCAL_RANK", 0)), True)


def init_from_env(device: torch.device) -> DistContext:
    """Join the process group that ``torchrun``'s environment describes (NCCL on
    cuda, gloo on cpu); a world of one when ``WORLD_SIZE`` is not set."""
    if dist.is_available() and dist.is_initialized():
        return current()
    if "WORLD_SIZE" not in os.environ:
        return DistContext()
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if device.type == "cuda":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend="nccl" if device.type == "cuda" else "gloo", init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    return current()


def local_device(ctx: DistContext, device: torch.device) -> torch.device:
    """``cuda:<local rank>`` for a cuda run in a group, else ``device``."""
    return torch.device("cuda", ctx.local_rank) if device.type == "cuda" and ctx.grouped else device


def average_grads(ctx: DistContext, params: Iterable[torch.Tensor]) -> None:
    """Replace every gradient by its mean over the ranks (one flat all-reduce)."""
    if not ctx.grouped:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= ctx.world_size
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()


def average_metrics(ctx: DistContext, metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Scalar metrics averaged over the ranks, as Python floats (for logging)."""
    names = sorted(metrics)
    vals = torch.stack([metrics[k].detach().reshape(()).to(torch.float32) for k in names])
    if ctx.grouped:
        dist.all_reduce(vals)
        vals /= ctx.world_size
    return dict(zip(names, vals.tolist()))


def all_gather_rows(ctx: DistContext, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``t`` along ``dim`` in rank order."""
    if not ctx.grouped:
        return t
    t = t.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(t) for _ in range(ctx.world_size)]
    dist.all_gather(parts, t)
    return torch.cat(parts, dim=dim)
