"""Whole tensors from a rank's parts under ``pipe`` and ``model``, and a
rank's parts from whole tensors: what the gathered checkpoint, the
resume at any world size, K-FAC's preconditioner (parallel/ layers of
optim/kfac.py) and the parameter digests read.

A tensor's name is the single-process model's (a pipeline stage's layers
keep their global indices, parallel/pipeline.py). :func:`gather_full`
concatenates the ``model`` ranks' parts on the split dimension
(parallel/tensor_parallel.py ``SPLITS``) and hands every stage the other
stages' layers (one broadcast a tensor over ``pipe``, from the stage
that holds it); replicated tensors are this rank's own. Every rank of the
groups calls it, with the same names, in the same order (collectives).
:func:`local_state` is the inverse: this rank's layers and model parts
of whole tensors.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch
import torch.distributed as dist

from bert_pytorch_tpu_torch.parallel import tensor_parallel as tp_lib

_LAYER = re.compile(r"^(.*\.encoder\.layers\.)(\d+)(\..+)$")


def _gather_model(name: str, t: torch.Tensor, axis) -> torch.Tensor:
    found = tp_lib.split_of(name)
    if axis is None or found is None:
        return t
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t.contiguous(), group=axis.group)
    return torch.cat(parts, dim=found[0])


def gather_full(named: Dict[str, torch.Tensor], model_axis=None,
                pipe=None, n_layers: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """Whole tensors by name from this rank's parts ``named`` (a state
    dict, the gradients or the moments, by parameter name): every layer
    of the stack and the full width of every split tensor."""
    out = {name: _gather_model(name, t.detach(), model_axis)
           for name, t in sorted(named.items())}
    if pipe is None:
        return out
    from bert_pytorch_tpu_torch.parallel.pipeline import stage_layers

    mine = stage_layers(n_layers, pipe)
    # (position in the stage, rest of the name): the same order on every
    # stage.
    layered = {}
    for name, t in out.items():
        match = _LAYER.match(name)
        if match:
            # Host-resident: a regex group of a parameter name.
            # torchlint: disable=HS101
            key = (int(match.group(2)) - mine[0], match.group(1),
                   match.group(3))
            layered[key] = t
    for stage in range(pipe.size):
        src = pipe.ranks[stage]
        first = stage * len(mine)
        for key in sorted(layered):
            position, head, tail = key
            t = layered[key]
            target = f"{head}{first + position}{tail}"
            buf = t if stage == pipe.index else torch.empty_like(t)
            dist.broadcast(buf, src, group=pipe.group)
            out[target] = buf
    return out


def local_state(full: Dict[str, torch.Tensor], names, model_axis=None
                ) -> Dict[str, torch.Tensor]:
    """This rank's part of each of ``names`` (its local names) from the
    whole tensors ``full``."""
    return {name: tp_lib.local_part(name, full[name], model_axis)
            for name in names}


def full_shapes(model: torch.nn.Module, model_axis=None, pipe=None,
                n_layers: Optional[int] = None) -> Dict[str, tuple]:
    """The whole shape of every state-dict entry of the single-process
    model, from this rank's ``model`` (no collective)."""
    shapes = {}
    state = model.state_dict()
    for name, t in state.items():
        shape = list(t.shape)
        found = tp_lib.split_of(name)
        if model_axis is not None and found is not None:
            shape[found[0]] *= model_axis.size
        shapes[name] = tuple(shape)
    if pipe is None:
        return shapes
    for name in list(shapes):
        match = _LAYER.match(name)
        if match:
            for i in range(n_layers):
                shapes[f"{match.group(1)}{i}{match.group(3)}"] = shapes[name]
    return shapes
