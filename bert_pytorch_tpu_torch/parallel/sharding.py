"""Fully-sharded parameters: FSDP2 over the run's mesh, and the helpers
that let the optimizers, the train step and the checkpoints work on one
rank's shard (the port of the JAX package's ``parallel/sharding.py`` and
``pretrain.state_shardings``).

:func:`shard_model` calls FSDP2's ``fully_shard`` on each encoder layer,
then on the heads that do not read the word table (the MLM transform, the
pooler, the NSP classifier), then on the root. On a 2-D ``(data, fsdp)``
mesh this is HSDP: each parameter is sharded on its first dimension over
``fsdp`` and replicated over ``data``. The embeddings stay in the root's
group, because the MLM decoder reads the word table outside the
embeddings' forward (the tied weight); the root's parameters stay
gathered from its forward to its backward. The gradients FSDP reduces are
sums (its divide factor is 1): the train step already divides each rank's
loss sums by the GLOBAL counts (pretrain.py).

The mesh is the run's whole ``(data, fsdp, pipe, seq, model)`` mesh; FSDP2
takes its ``(data, fsdp)`` sub-mesh, one per coordinate of the other
axes. Under ``pipe`` the encoder holds its stage's layers only
(parallel/pipeline.py ``stage_model``), so each stage's layers are units
over that stage's ``fsdp`` group, and the root's ``stage_forward`` is
registered as a forward of the root: the GPipe schedule never calls the
root's ``forward``, and the root must run first (FSDP2's lazy init) and
keep the tied word table gathered until its last use. Under ``seq`` FSDP2
sums over ``data x fsdp`` only; the step adds the ``seq`` sum of the
local shards (pretrain.py ``_sum_unreduced``).

Each sharded parameter is a ``DTensor``; :func:`local` is its shard on
this rank, :func:`row_range` the rows of the full tensor that shard holds
(``torch.chunk`` on dimension 0 over the ``fsdp`` ranks, as FSDP2 shards).
Norms over sharded tensors are local sums of squares, added over the
shard group by one all-reduce of a vector (:func:`sum_over_shards`), never
one collective per tensor.
"""

from __future__ import annotations

import sys
from typing import Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from bert_pytorch_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_FSDP


def _dtensor_module():
    """``torch.distributed.tensor`` if something imported it (every
    DTensor comes from there), else None. Not imported here: it costs a
    replica's start about a second, and a run without FSDP has none."""
    return sys.modules.get("torch.distributed.tensor")


def is_dtensor(t) -> bool:
    module = _dtensor_module()
    return module is not None and isinstance(t, module.DTensor)


def local(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """This rank's shard of a DTensor; any other tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def is_sharded(t) -> bool:
    return is_dtensor(t) and any(
        isinstance(p, _dtensor_module().Shard) for p in t.placements)


def shard_group(tensors: Iterable[torch.Tensor]):
    """The process group over which the first sharded tensor of
    ``tensors`` is split (its mesh's ``fsdp`` dimension), or None when
    none is sharded."""
    for t in tensors:
        if is_sharded(t):
            mesh = t.device_mesh
            if mesh.mesh_dim_names and AXIS_FSDP in mesh.mesh_dim_names:
                return mesh.get_group(AXIS_FSDP)
            return mesh.get_group(0)
    return None


def sum_over_shards(values: torch.Tensor, group) -> torch.Tensor:
    """``values`` (local partial sums, one vector) summed over the shard
    group; ``values`` itself when ``group`` is None."""
    if group is None:
        return values
    values = values.clone()
    dist.all_reduce(values, op=dist.ReduceOp.SUM, group=group)
    return values


def all_finite_across_ranks(finite: bool, device) -> bool:
    """Whether every rank of the run found its gradients finite (a MIN
    all-reduce of the flag over the default group), so that one rank
    never skips a step while another takes it."""
    flag = torch.tensor([1 if finite else 0], dtype=torch.int32,
                        device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    # A per-step sync of the fp16 step across ranks, kept: every rank
    # branches on the agreed flag (see DynamicLossScale.step).
    return bool(flag.item())  # torchlint: disable=HS101


def row_range(t: torch.Tensor) -> Tuple[int, int]:
    """(start, stop) of dimension 0 of the full tensor that this rank's
    shard holds: all rows for an unsharded tensor; for a DTensor sharded
    on dimension 0 over ``k`` ranks, ``torch.chunk``'s chunk of this
    rank's coordinate (chunks of ceil(n / k) rows; trailing ranks may
    hold fewer, or none)."""
    n = t.shape[0] if t.dim() else 1
    if not is_sharded(t):
        return 0, n
    mesh = t.device_mesh
    start, stop = 0, n
    for dim, placement in enumerate(t.placements):
        if isinstance(placement, _dtensor_module().Shard):
            if placement.dim != 0:
                raise ValueError(f"row_range expects Shard(0), got "
                                 f"{t.placements}")
            k, coord = mesh.size(dim), mesh.get_local_rank(dim)
            rows = stop - start
            chunk = -(-rows // k)
            lo = min(start + coord * chunk, stop)
            start, stop = lo, min(lo + chunk, stop)
    return start, stop


def local_rows(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The rows of ``full`` (a whole tensor) that ``like``'s shard holds on
    this rank; ``full`` itself when ``like`` is not sharded."""
    if not is_sharded(like):
        return full
    start, stop = row_range(like)
    return full[start:stop]


def as_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``full`` laid out as ``like``: a DTensor of this rank's rows when
    ``like`` is one (no collective), else ``full``."""
    if not is_dtensor(like):
        return full
    return _dtensor_module().DTensor.from_local(
        local_rows(full, like).contiguous(), like.device_mesh,
        like.placements, run_check=False, shape=like.shape,
        stride=like.stride())


def gather_like(shard: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which ``shard`` (this rank's rows) is a part,
    sharded as ``like``: one ``all_gather_into_tensor`` of the rows,
    padded to ``torch.chunk``'s chunk, over the shard group (a collective:
    every rank calls it in the same order); ``shard`` itself when ``like``
    is not sharded. The c10d collective, not ``DTensor.full_tensor``:
    the functional collective under it crashed the process on CUDA
    tensors over gloo (torch 2.11, two ranks sharing one H100)."""
    if not is_sharded(like):
        return shard
    group = shard_group([like])
    k = dist.get_world_size(group)
    n = like.shape[0]
    chunk = -(-n // k)
    padded = shard.new_zeros((chunk,) + tuple(shard.shape[1:]))
    padded[:shard.shape[0]] = shard
    out = shard.new_empty((chunk * k,) + tuple(shard.shape[1:]))
    dist.all_gather_into_tensor(out, padded, group=group)
    return out[:n]


def full_state_dict(model: torch.nn.Module) -> dict:
    """``model.state_dict()`` with every sharded tensor gathered whole (a
    collective per sharded tensor, in the state dict's order)."""
    return {k: gather_like(v.to_local(), v) if is_dtensor(v) else v
            for k, v in model.state_dict().items()}


def fsdp_mesh(mesh):
    """The mesh FSDP2 shards over: the 1-D ``fsdp`` sub-mesh when ``data``
    is 1, else the 2-D ``(data, fsdp)`` mesh (HSDP)."""
    if mesh.size(0) == 1:
        return mesh[AXIS_FSDP]
    return mesh[(AXIS_DATA, AXIS_FSDP)]


def shard_model(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """FSDP2 over ``mesh`` when its ``fsdp`` axis is above 1 (see the
    module docstring), the model itself otherwise. The weights are the
    model's at the call (seeded, or converted with ``from_jax_params``
    and loaded before it)."""
    if mesh is None or mesh[AXIS_FSDP].size() == 1:
        return model
    from torch.distributed.fsdp import (FSDPModule, fully_shard,
                                        register_fsdp_forward_method)

    shard_mesh = fsdp_mesh(mesh)
    units = list(model.bert.encoder.layers)
    units.append(model.predictions.transform)
    if getattr(model.bert, "pooler", None) is not None:
        units.append(model.bert.pooler)
    if getattr(model, "seq_relationship", None) is not None:
        units.append(model.seq_relationship)
    for unit in units:
        fully_shard(unit, mesh=shard_mesh)
    fully_shard(model, mesh=shard_mesh)
    # A pipeline stage's share of a microbatch is a root forward too.
    if hasattr(model, "stage_forward"):
        register_fsdp_forward_method(model, "stage_forward")
    for module in model.modules():
        if isinstance(module, FSDPModule):
            module.set_gradient_divide_factor(1.0)
            # Plain SUM collectives (gloo has no PREMUL_SUM).
            module.set_force_sum_reduction_for_comms(True)
    return model


def is_fsdp(model: torch.nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)
