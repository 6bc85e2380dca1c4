"""The data-parallel gradient reduction, plain or bucketed for overlap:
the port of the JAX package's ``parallel/overlap.py`` (``bucketed_psum``)
and of the reduction its ``pretrain.py`` steps do over the batch axes.

Each rank's backward leaves LOCAL gradient sums in the parameters'
``.grad`` (the train step divides each rank's loss sums by the global
counts, so the sum over ranks is the global-mean gradient).
:class:`GradReducer` sums them over the data-parallel group once per
optimizer step, after the last microbatch:

* plain: one flat all-reduce of every gradient, the shape of the JAX
  step's implicit reduction;
* ``overlap=True`` (``--overlap_grad_reduce``): three buckets in the
  order their gradients become available during the backward — task
  heads, the encoder stack, the embeddings (JAX ``overlap.py:26-42``).
  On the last microbatch each parameter's post-accumulate-grad hook
  counts it in; when a bucket's last gradient has accumulated, its flat
  all-reduce is launched asynchronously, so the heads' and the encoder's
  reductions run under the rest of the backward. :meth:`finish` waits on
  all of them before the optimizer. A sum is a sum: both give the same
  gradients to fp32 roundoff.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

# Availability order of the top-level parameter groups during the
# backward: head gradients materialize first, embeddings last. Bucket ids
# double as launch order.
BUCKET_HEADS = 0
BUCKET_ENCODER = 1
BUCKET_EMBEDDINGS = 2
N_BUCKETS = 3
BUCKET_NAMES = ("heads", "encoder", "embeddings")


def bucket_of(name: str) -> int:
    """The availability bucket of a parameter name (the JAX
    ``_bucket_of`` on the params path)."""
    parts = set(name.split("."))
    if "embeddings" in parts:
        return BUCKET_EMBEDDINGS
    if "encoder" in parts:
        return BUCKET_ENCODER
    return BUCKET_HEADS


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def all_reduce_flat(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum ``tensors`` over ``group`` (the default group when None) in
    place: one all-reduce of their concatenation."""
    flat = _flat(tensors)
    dist.all_reduce(flat, group=group)
    _unflat(flat, tensors)


class GradReducer:
    """Sums the gradients of ``named`` (name, parameter) over ``group``
    (the default process group when None) once per step. Call :meth:`arm` before the
    last microbatch's backward and :meth:`finish` after it; parameters
    without a gradient get zeros. ``launches`` records, per step, the
    buckets in the order their reductions were launched (a plain reducer
    records one entry, ``"all"``)."""

    def __init__(self, named: Sequence[Tuple[str, torch.nn.Parameter]],
                 overlap: bool = False, group=None):
        self.params = [p for _, p in named]
        self.overlap = overlap
        self.group = group
        self.launches: List[str] = []
        self._armed = False
        self._pending: Dict[int, tuple] = {}
        self._buckets: List[List[torch.nn.Parameter]] = [
            [] for _ in range(N_BUCKETS)]
        for name, p in named:
            self._buckets[bucket_of(name)].append(p)
        self._bucket_of = {id(p): bucket_of(n) for n, p in named}
        self._seen: Dict[int, int] = {}
        if overlap:
            for p in self.params:
                p.register_post_accumulate_grad_hook(self._on_grad)

    def arm(self) -> None:
        """The next backward is the step's last: launch each bucket's
        reduction as soon as its gradients are complete."""
        self._armed = self.overlap
        self._seen = {b: 0 for b in range(N_BUCKETS)}
        self._pending = {}

    def _on_grad(self, p: torch.nn.Parameter) -> None:
        if not self._armed:
            return
        bucket = self._bucket_of[id(p)]
        self._seen[bucket] += 1
        if self._seen[bucket] == len(self._buckets[bucket]):
            self._launch(bucket)

    def _launch(self, bucket: int) -> None:
        params = self._buckets[bucket]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        flat = _flat(grads)
        work = dist.all_reduce(flat, group=self.group, async_op=True)
        self._pending[bucket] = (work, flat, grads)
        self.launches.append(BUCKET_NAMES[bucket])

    def finish(self) -> None:
        """Complete the step's reduction: the plain flat all-reduce, or
        the launch of any bucket whose gradients never all arrived (a
        parameter the step did not reach) and the wait on every bucket."""
        self._armed = False
        if not self.overlap:
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            all_reduce_flat([p.grad for p in self.params], self.group)
            self.launches.append("all")
            return
        for bucket in range(N_BUCKETS):
            if bucket not in self._pending and self._buckets[bucket]:
                self._launch(bucket)
        for bucket in sorted(self._pending):
            work, flat, grads = self._pending[bucket]
            work.wait()
            _unflat(flat, grads)
        self._pending = {}
