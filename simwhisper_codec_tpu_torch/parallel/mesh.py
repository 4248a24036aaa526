"""Tensor parallelism over ``torch.distributed``: a (data, model) grid of ranks.

Counterpart of ``simwhisper_codec_tpu/parallel/mesh.py``.  One process a
rank (``torchrun``); rank r sits at (r // model_axis, r % model_axis), as
the JAX mesh reshapes its devices.  The ``data`` axis splits the batch; the
``model`` axis shards the attention heads and the FFN / ConvNeXt
intermediate width, Megatron style:

 - column-parallel ``q_proj``, ``k_proj``, ``v_proj``, ``fc1``, ``pwconv1``:
   a rank holds a slice of the output rows (of its heads, of I), biases and
   the int8 row scales ``fc1_s`` / ``pw1_s`` sliced with them;
 - row-parallel ``out_proj``, ``fc2``, ``pwconv2``: a rank holds the
   matching slice of the input columns and forms a partial sum, which the
   model group all-reduces; the bias is added once, after the reduction.

XLA derives where to reduce from the shardings and hides the biases'
placement; explicit TP does not, so the column biases travel with their
rows and the row biases stay whole.  Activations are replicated over
``model``.  ``copy_to_model`` and ``reduce_from_model`` (Megatron's f and
g) carry the reductions through autograd.  Only ``all_reduce`` (SUM, MAX)
and ``broadcast`` are used, which gloo also runs on CUDA tensors: a model
group of two processes can share one card over gloo.

A model axis of one is the one-process code path: no group, no collective.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from simwhisper_codec_tpu_torch.parallel.dist import DistContext

COLUMN_PARALLEL = ("q_proj", "k_proj", "v_proj", "fc1", "pwconv1")
ROW_PARALLEL = ("out_proj", "fc2", "pwconv2")
# int8 copies of ops/quant.py: the first FFN matrix and its per-row scales
# shard with fc1 / pwconv1's rows; the second matrix with its columns, its
# per-output-channel scales (over all of I) stay whole
INT8_ROWS = ("fc1_q", "fc1_s", "pw1_q", "pw1_s")
INT8_COLUMNS = ("fc2_q", "pw2_q")


@dataclass(frozen=True)
class Mesh:
    """This process's place on the (data, model) grid; a group is None on an axis of one rank."""

    data_size: int = 1
    model_size: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    def data_context(self) -> DistContext:
        """The ``data`` axis as a ``DistContext`` (batch rows, gradient and metric averages)."""
        return DistContext(self.data_rank, self.data_size, 0, self.data_size > 1, self.data_group)


def make_mesh(n_ranks: Optional[int] = None, model_axis: int = 1) -> Mesh:
    """The (data, model) mesh over the ranks of the initialised process group
    (a world of one without one).  Every rank must call it: it creates every
    data and model group, in one order on all ranks."""
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    n = n_ranks or world
    if model_axis < 1 or n % model_axis != 0:
        raise ValueError(f"n_ranks {n} not divisible by model_axis {model_axis}")
    if n != world:
        raise ValueError(f"make_mesh needs {n} ranks but the process group has {world}; start one process a "
                         f"rank (torchrun --nproc_per_node {n})")
    rank = dist.get_rank() if grouped else 0
    data_size = n // model_axis
    model_groups = [dist.new_group(list(range(d * model_axis, (d + 1) * model_axis)))
                    for d in range(data_size)] if model_axis > 1 else None
    data_groups = [dist.new_group(list(range(m, n, model_axis)))
                   for m in range(model_axis)] if data_size > 1 else None
    d, m = divmod(rank, model_axis)
    return Mesh(data_size, model_axis, d, m, data_groups[m] if data_groups else None,
                model_groups[d] if model_groups else None)


def param_sharding_rules(key: str) -> Optional[int]:
    """The dim of a codec tensor (state-dict key, or an int8 buffer's name)
    that is sharded over ``model``, in torch's (out, in) layout; None if it is
    replicated."""
    parts = key.split(".")
    leaf, owner = parts[-1], parts[-2] if len(parts) > 1 else ""
    if (owner in COLUMN_PARALLEL and leaf in ("weight", "bias")) or leaf in INT8_ROWS:
        return 0
    if (owner in ROW_PARALLEL and leaf == "weight") or leaf in INT8_COLUMNS:
        return 1
    return None


def shard(t: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    """This model rank's slice of ``t`` along ``dim`` (all of it for None)."""
    if dim is None or mesh.model_size == 1:
        return t
    size = t.shape[dim]
    if size % mesh.model_size:
        raise ValueError(f"dim {dim} of size {size} does not split over {mesh.model_size} model ranks")
    per = size // mesh.model_size
    return t.narrow(dim, mesh.model_rank * per, per).clone()


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """This rank's copy of ``model`` with every tensor that
    ``param_sharding_rules`` names cut to its slice, its attention layers
    holding their local heads (head dim unchanged) and every sharded layer
    its model group.  int8 copies present on ``model`` are sliced as they
    are: quantise the whole model first (``AudioCodec`` does), since a
    per-output-channel scale of ``fc2`` / ``pwconv2`` runs over all of I.
    A model axis of one returns ``model`` itself."""
    from simwhisper_codec_tpu_torch.models.transformer import SelfAttention, TransformerLayer
    from simwhisper_codec_tpu_torch.models.vocos import ConvNeXtBlock

    if mesh.model_size == 1:
        return model
    out = copy.deepcopy(model)
    for name, mod in out.named_modules():
        for store in (mod._parameters, mod._buffers):
            for leaf, t in list(store.items()):
                dim = param_sharding_rules(f"{name}.{leaf}" if name else leaf)
                if t is None or dim is None:
                    continue
                part = shard(t.detach(), dim, mesh)
                store[leaf] = nn.Parameter(part, requires_grad=t.requires_grad) if store is mod._parameters else part
        if isinstance(mod, nn.Linear):
            mod.out_features, mod.in_features = mod.weight.shape
        if isinstance(mod, SelfAttention):
            if mod.num_heads % mesh.model_size:
                raise ValueError(f"{mod.num_heads} heads do not split over {mesh.model_size} model ranks")
            mod.num_heads //= mesh.model_size
        if isinstance(mod, (SelfAttention, TransformerLayer, ConvNeXtBlock)):
            mod.model_group = mesh.model_group
    return out


# -- the region functions (Megatron's f and g) ---------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, gradient all-reduced over the model group: the input of a column-parallel region."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the model group forward, identity backward: the output of a row-parallel region."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def row_parallel(x: torch.Tensor, lin: nn.Linear, group) -> torch.Tensor:
    """A row-parallel ``nn.Linear`` on this rank's slice of the input: the
    partial product in f32 (bf16 operands multiply exactly there; TF32 keeps
    them exact too), summed over the model group, rounded to x.dtype once,
    then the bias, once, in x.dtype."""
    part = F.linear(x.to(torch.float32), lin.weight.to(x.dtype).to(torch.float32))
    return reduce_from_model(part, group).to(x.dtype) + lin.bias.to(x.dtype)


# -- the data axis and whole tensors -------------------------------------------

def batch_rows(mesh: Mesh, n: int) -> slice:
    """This data rank's rows of a global batch of ``n`` (every model rank of it takes the same)."""
    return mesh.data_context().rows(n)


def _sum_of_placed(t: torch.Tensor, dim: int, index: int, count: int, group) -> torch.Tensor:
    """``t`` placed at block ``index`` of ``count`` along ``dim`` in zeros and
    summed over ``group``: every rank's block, by all_reduce alone (adding
    zeros is exact)."""
    parts = [torch.zeros_like(t) for _ in range(count)]
    parts[index] = t
    full = torch.cat(parts, dim)
    dist.all_reduce(full, group=group)
    return full


def gather_rows(mesh: Mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every data rank's ``t`` concatenated along ``dim`` in rank order."""
    if mesh.data_group is None:
        return t
    return _sum_of_placed(t.contiguous(), dim, mesh.data_rank, mesh.data_size, mesh.data_group)


def unshard(mesh: Mesh, key: str, t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of key ``key`` (a state-dict key) from every model rank's slice ``t``."""
    dim = param_sharding_rules(key)
    if dim is None or mesh.model_group is None:
        return t
    return _sum_of_placed(t.contiguous(), dim, mesh.model_rank, mesh.model_size, mesh.model_group)


def replicated(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Model rank 0's ``t`` on every rank of the model group (a copy)."""
    if mesh.model_group is None:
        return t
    out = t.contiguous().clone()
    dist.broadcast(out, src=mesh.data_rank * mesh.model_size, group=mesh.model_group)
    return out
