"""Point-to-point transfers between ranks of one axis group: the
pipeline's activations and their gradients (parallel/pipeline.py) and
the ring's K/V blocks (ops/ring.py), the port of the JAX ``ppermute``.

On nccl a tensor goes as it is. On gloo (two or more ranks sharing a
card, or the CPU) a CUDA tensor is copied into pinned host memory first
and the received bytes are copied back to the card: gloo's send and recv
take host buffers. The choice follows the backend
(``AxisGroup.host_staged``), never a failed attempt. The sends and
receives of one exchange go through ``batch_isend_irecv``: on nccl one
group of calls (two ranks sending to each other with ungrouped calls
would wait on each other's stream), on gloo one call each.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def _staged(t: torch.Tensor, host: bool) -> torch.Tensor:
    t = t.detach().contiguous()
    if host and t.is_cuda:
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t)
        return out
    return t


def exchange(send: Sequence[torch.Tensor], dst: int, src: int, group,
             host_staged: bool, recv_like: Sequence[torch.Tensor] = None
             ) -> List[torch.Tensor]:
    """Send ``send`` to global rank ``dst`` and receive as many tensors,
    shaped as ``recv_like`` (``send`` itself when None), from global rank
    ``src``, over ``group``: the sends and receives are posted together,
    then waited on. Either list may be empty (``dst`` or ``src`` None)."""
    recv_like = list(send) if recv_like is None else list(recv_like)
    ops, outs = [], []
    if dst is not None:
        ops += [dist.P2POp(dist.isend, _staged(t, host_staged), dst, group)
                for t in send]
    bufs = []
    if src is not None:
        for like in recv_like:
            host = host_staged and like.is_cuda
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device="cpu" if host else like.device,
                              pin_memory=host)
            ops.append(dist.P2POp(dist.irecv, buf, src, group))
            bufs.append((buf, like.device))
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    for buf, device in bufs:
        outs.append(buf.to(device, non_blocking=False)
                    if buf.device != device else buf)
    return outs


def send(tensors: Sequence[torch.Tensor], dst: int, group,
         host_staged: bool) -> None:
    exchange(tensors, dst, None, group, host_staged, [])


def recv(like: Sequence[torch.Tensor], src: int, group,
         host_staged: bool) -> List[torch.Tensor]:
    return exchange([], None, src, group, host_staged, like)
