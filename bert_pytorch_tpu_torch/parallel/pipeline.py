"""Pipeline parallelism: a GPipe schedule over the mesh's ``pipe`` axis,
the port of the JAX package's ``parallel/pipeline.py``
(``stage_layer_count``, ``gpipe``).

Only the encoder is staged: stage s of P holds layers [s·L/P, (s+1)·L/P)
(:func:`stage_model`; they keep their global names, so the checkpoints
and the optimizer's per-leaf norms see the JAX ``layers`` leaf on
``pipe``). The embeddings and the heads stay on every stage, as JAX
replicates them over ``pipe``; stage 0 runs the embeddings, the last
stage the heads and the loss, and the step sums their gradients over
``pipe`` (the tied word table takes the embedding's from stage 0 and the
decoder's from the last stage).

:func:`gpipe` is the schedule: the M microbatches run forward through the
P stages (stage s receives microbatch m's activations from s - 1, runs
its layers and sends them on while s - 1 starts on m + 1), then backward
in the same order (the last stage back-propagates its losses, every
stage sends its input's gradient to the one before). The transfers are
point-to-point (parallel/p2p.py; through pinned host memory on gloo).
Each stage keeps its microbatches' graphs until their backward, as
GPipe does; ``remat`` on the encoder keeps only each layer's boundary.

Under ``fsdp`` a stage's layers, heads and root are FSDP2 units over the
stage's own ``fsdp`` group (parallel/sharding.py). A stage's share of a
microbatch is one call of the model's ``stage_forward``, which FSDP2
hooks as the root's forward, so the root's parameters are gathered
before any layer runs and its gradients are reduced after its last
use. The step holds FSDP's gradient sync off until the last
microbatch's backward (``before_backward``), so each unit
reduce-scatters once a step, as the JAX step reduces once.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
from torch import nn

from bert_pytorch_tpu_torch.parallel import p2p


def stage_layer_count(n_layers: int, n_stages: int) -> int:
    if n_layers % n_stages != 0:
        raise ValueError(
            f"num_hidden_layers={n_layers} must divide by pipeline stages "
            f"={n_stages} (contiguous equal blocks per stage)")
    return n_layers // n_stages


def check_microbatches(n_mb: int, n_stages: int) -> None:
    if n_mb < n_stages:
        raise ValueError(
            f"pp needs accumulation_steps >= pipeline stages ({n_mb} < "
            f"{n_stages}): the pipeline's microbatches are the "
            "accumulation microbatches")


def stage_layers(n_layers: int, pipe) -> List[int]:
    """The global indices of the layers stage ``pipe.index`` holds."""
    per = stage_layer_count(n_layers, pipe.size)
    return list(range(pipe.index * per, (pipe.index + 1) * per))


class StageLayers(nn.Module):
    """A stage's encoder layers under their global indices (its state
    dict names ``layers.<global index>.*``); iterates in order and
    indexes by global index."""

    def __init__(self, layers: dict):
        super().__init__()
        for index, layer in layers.items():
            self.add_module(str(index), layer)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self) -> int:
        return len(self._modules)

    def __getitem__(self, index: int) -> nn.Module:
        return self._modules[str(index)]


def stage_model(model: nn.Module, pipe) -> nn.Module:
    """Keep stage ``pipe.index``'s layers of ``model.bert.encoder`` (the
    rest are dropped); the model itself without a ``pipe`` axis."""
    if pipe is None:
        return model
    encoder = model.bert.encoder
    ids = stage_layers(len(encoder.layers), pipe)
    encoder.layers = StageLayers({i: encoder.layers[i] for i in ids})
    encoder.layer_ids = ids
    return model


def gpipe(n_mb: int, pipe, part: Callable, like: Callable,
          backward: bool = True,
          before_backward: Optional[Callable[[int], None]] = None) -> list:
    """Run ``n_mb`` microbatches forward and backward through the stages.

    ``part(m, x)`` runs this stage's whole share of microbatch m (one
    call, so that an FSDP2 root sees one forward a microbatch): ``x`` is
    the activations received from the stage before (None on stage 0,
    which embeds the microbatch itself); on the last stage it gives (a
    scalar to back-propagate, anything else), elsewhere the activations
    to send on. ``like(m)`` is an empty tensor shaped as the activations
    between stages. ``before_backward(m)`` (optional) runs before
    microbatch m's backward on every stage. Returns the last stage's
    ``part`` results (an empty list elsewhere); the parameters' ``.grad``
    hold the step's gradients from this stage's part of the graph.
    ``backward=False`` runs the forward only (``part`` may then give
    anything on the last stage: its results are returned as they
    are)."""
    s, n = pipe.index, pipe.size
    prev = pipe.peer(-1) if s > 0 else None
    nxt = pipe.peer(1) if s < n - 1 else None
    saved, results = [], []
    for m in range(n_mb):
        x = None
        if prev is not None:
            (x,) = p2p.recv([like(m)], prev, pipe.group, pipe.host_staged)
            x.requires_grad_(backward)
        y = part(m, x)
        if nxt is None and not backward:
            results.append(y)
        elif nxt is None:
            loss, extra = y
            saved.append((x, loss))
            results.append((loss.detach(), extra))
        else:
            p2p.send([y], nxt, pipe.group, pipe.host_staged)
            if backward:
                saved.append((x, y))
    if not backward:
        return results
    for m in range(n_mb):
        x, out = saved[m]
        if before_backward is not None:
            before_backward(m)
        if nxt is None:
            out.backward()
        else:
            (grad,) = p2p.recv([out], nxt, pipe.group, pipe.host_staged)
            torch.autograd.backward(out, grad)
        if prev is not None:
            p2p.send([x.grad], prev, pipe.group, pipe.host_staged)
        saved[m] = None
    return results
