"""Dynamic micro-batching for online inference (docs/serving.md).

A :class:`Batcher` owns a thread-safe FIFO of :class:`Request` objects fed
by the HTTP worker threads and drained by the single dispatch thread
(serve/service.py). Batches form per task head (one jitted forward serves
one head) and flush on whichever comes first:

* **size** — the head-of-queue task has accumulated a full batch
  (``max_batch_size`` requests, or ``max_batch_size * max_requests_per_pack``
  when packing — packed rows hold several requests each);
* **deadline** — the OLDEST pending request has waited ``max_wait_ms``
  (tail latency is bounded by the oldest request, not the newest).

The flush policy is deliberately separated from the blocking machinery:
:meth:`poll` is a non-blocking pure function of (queue state, clock) so
tests drive it deterministically with an injected fake clock, while
:meth:`next_batch` adds the condition-variable wait the dispatch thread
uses in production. The pipelined dispatch plane (docs/serving.md
"Continuous batching") grows a third path out of the same flush
machinery: :meth:`admit_into_forming` lets the assembler stage admit
requests that arrive WHILE a previous batch executes into the batch it
is still forming — continuous batching's iteration-level admission (Yu
et al., OSDI 2022) adapted to the one-shot encoder workload — instead
of parking them for the next flush.

Length-aware grouping happens downstream: the batcher keeps arrival order
(FIFO fairness bounds worst-case wait), and the engine's batch planner
(serve/engine.py ``plan_batch``) picks the smallest length bucket — and,
when packing, the row assignment — for the flushed group, returning any
requests that did not fit to :meth:`requeue_front`.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, List, Optional


class BatcherFull(RuntimeError):
    """Raised by :meth:`Batcher.submit` when the pending queue is at its
    ``max_pending`` cap — the load-shedding signal the HTTP layer turns
    into a 503 instead of letting memory (and client-visible latency)
    grow without bound under sustained overload."""


class Request:
    """One in-flight inference request.

    ``features`` is the task's prepared input (serve/tasks.py): a dict with
    unpadded ``input_ids``/``segment_ids`` plus task-specific decode
    context. ``length`` (tokens incl. specials) drives bucket selection and
    packing. The dispatch thread fulfils the request via :meth:`set_result`
    / :meth:`set_error`; the submitting thread blocks in :meth:`wait`.
    A submitter that gives up marks the request ``abandoned`` so the
    dispatch thread skips it instead of spending device time on a result
    nobody is waiting for.
    """

    _ids = itertools.count()

    def __init__(self, task: str, features: dict, payload: dict,
                 enqueued_at: Optional[float] = None):
        self.id = next(Request._ids)
        self.task = task
        self.features = features
        self.payload = payload
        self.length = len(features["input_ids"])
        # None until Batcher.submit stamps it (or process_batch, for
        # directly-constructed requests that never enter the queue) —
        # a sentinel, not 0.0, so an injected clock legitimately reading
        # 0.0 is never mistaken for "unstamped".
        self.enqueued_at = enqueued_at
        # Stamped by the batcher when the dispatch thread pops the
        # request (re-stamped after a plan-leftover requeue, so the
        # trace's queue span covers the whole time spent waiting).
        self.dequeued_at = enqueued_at
        # Host prepare() time measured by the submitting thread
        # (serve/service.py) — pre-queue, so trace context, not a span.
        self.prepare_s: float = 0.0
        # Inbound router trace context (serve/tracing.py
        # parse_trace_header), stamped by ServingService.submit like
        # prepare_s; the dispatch thread forwards it to the tracer so
        # the emitted serve_trace chains to the router's span tree.
        self.trace_ctx: Optional[dict] = None
        self.completed_at: Optional[float] = None
        self.result: Optional[dict] = None
        self.error: Optional[str] = None
        self.abandoned = False
        # True when the request joined a FORMING batch through the
        # admission window (Batcher.admit_into_forming) instead of a
        # normal flush — the continuous-batching win the serve_trace
        # `admitted_late` field and the admitted-late counters report.
        self.admitted_late = False
        # Filled by the dispatch thread for telemetry: seconds of jitted
        # forward (incl. the device sync) the request's batch cost.
        self.device_s: Optional[float] = None
        self._done = threading.Event()

    def set_result(self, result: dict, completed_at: float) -> None:
        self.result = result
        self.completed_at = completed_at
        self._done.set()

    def set_error(self, error: str, completed_at: float) -> None:
        self.error = error
        self.completed_at = completed_at
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)


class Batcher:
    def __init__(
        self,
        max_batch_size: int = 8,
        max_wait_ms: float = 5.0,
        max_requests_per_pack: int = 1,
        max_pending: int = 1024,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_batch_size < 1:
            raise ValueError(
                f"max_batch_size must be >= 1, got {max_batch_size}")
        if max_requests_per_pack < 1:
            raise ValueError(
                "max_requests_per_pack must be >= 1, got "
                f"{max_requests_per_pack}")
        self.max_batch_size = int(max_batch_size)
        self.max_wait_ms = float(max_wait_ms)
        self.max_requests_per_pack = int(max_requests_per_pack)
        self.max_pending = int(max_pending)
        self._clock = clock
        self._pending: List[Request] = []
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        # Requests popped by the dispatch thread but not yet finished
        # (fulfilled, errored, or requeued as plan leftovers). Drain
        # (service.stop) must wait on pending + in-flight, not pending
        # alone: depth() reads 0 the instant a batch is popped, and a
        # stop() racing that window used to close the batcher while the
        # dispatch thread still held requests whose plan leftovers it
        # was about to requeue — stranding them with blocked waiters
        # (the requeue-during-drain ordering bug).
        self._inflight = 0
        # Gauges for the serve telemetry window (serve/stats.py).
        self.depth_max = 0
        self.submitted = 0

    # -- producer side ---------------------------------------------------

    def submit(self, request: Request) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if len(self._pending) >= self.max_pending:
                raise BatcherFull(
                    f"pending queue at max_pending={self.max_pending}; "
                    "shedding load")
            request.enqueued_at = self._clock()
            self._pending.append(request)
            self.submitted += 1
            self.depth_max = max(self.depth_max, len(self._pending))
            self._cond.notify()

    def requeue_front(self, requests: List[Request]) -> None:
        """Return requests a partial dispatch could not fit to the FRONT of
        the queue (they are the oldest; FIFO order is preserved). They
        move from in-flight back to pending, so :meth:`unfinished` never
        dips while a leftover is in transit — the drain loop's evidence.
        A requeued request is no longer late-admitted, whatever path
        popped it: it will ride a future flush like any pending request,
        and the admitted_late marker must describe the batch that
        actually serves it.
        """
        if not requests:
            return
        with self._cond:
            for req in requests:
                req.admitted_late = False
            self._pending[:0] = requests
            # max(0, ...): tests/offline callers may requeue requests
            # they never popped; the counter must not go negative.
            self._inflight = max(0, self._inflight - len(requests))
            self.depth_max = max(self.depth_max, len(self._pending))
            self._cond.notify()

    def done(self, n: int) -> None:
        """The dispatch thread finished ``n`` popped requests (result,
        error, or abandoned-and-skipped — anything except a requeue,
        which re-counts itself)."""
        if n <= 0:
            return
        with self._cond:
            self._inflight = max(0, self._inflight - n)
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- consumer side ---------------------------------------------------

    def flush_size(self) -> int:
        """Requests of the head task that justify a size flush — also
        the budget an admission window may grow a forming batch to
        (:meth:`admit_into_forming`)."""
        return self.max_batch_size * self.max_requests_per_pack

    def _take_head_task_locked(self) -> List[Request]:
        """Pop up to a full batch of the HEAD request's task, preserving
        both the taken group's and the remainder's arrival order."""
        head_task = self._pending[0].task
        take, keep = [], []
        limit = self.flush_size()
        for req in self._pending:
            if req.task == head_task and len(take) < limit:
                take.append(req)
            else:
                keep.append(req)
        self._pending = keep
        self._inflight += len(take)
        now = self._clock()
        for req in take:
            # Trace queue span: enqueued_at -> this pop (serve/tracing.py).
            req.dequeued_at = now
        return take

    def poll(self) -> Optional[List[Request]]:
        """Non-blocking: the next batch if one is DUE (size or deadline),
        else None. The deadline check uses the injected clock, so tests
        advance a fake clock instead of sleeping."""
        with self._cond:
            if not self._pending:
                return None
            head_task = self._pending[0].task
            n_head = sum(1 for r in self._pending if r.task == head_task)
            oldest_wait_ms = (self._clock()
                              - self._pending[0].enqueued_at) * 1000.0
            if (n_head >= self.flush_size()
                    or oldest_wait_ms >= self.max_wait_ms):
                return self._take_head_task_locked()
            return None

    def next_batch(self, timeout: Optional[float] = None
                   ) -> Optional[List[Request]]:
        """Blocking: wait until a batch is due (or the batcher closes /
        ``timeout`` elapses) and return it. The wait granularity is the
        time to the oldest request's deadline, so a lone request is
        dispatched ~``max_wait_ms`` after arrival without polling."""
        deadline = None if timeout is None else self._clock() + timeout
        while True:
            batch = self.poll()
            if batch is not None:
                return batch
            with self._cond:
                if self._closed and not self._pending:
                    return None
                if deadline is not None and self._clock() >= deadline:
                    return None
                waits = []
                if self._pending:
                    waits.append(max(
                        0.0,
                        self._pending[0].enqueued_at
                        + self.max_wait_ms / 1000.0 - self._clock()))
                if deadline is not None:
                    waits.append(max(0.0, deadline - self._clock()))
                self._cond.wait(timeout=min(waits) if waits else None)

    def admit_into_forming(self, task: str, limit: int) -> List[Request]:
        """Admission-window path (pipelined dispatch, docs/serving.md
        "Continuous batching"): pop up to ``limit`` pending requests of
        ``task`` so the assembler can fold them into the batch it is
        still FORMING while the executor runs the previous one — they
        ride the next device step instead of waiting for their own
        flush. Popped requests are stamped ``dequeued_at`` (their queue
        span ends at admission) and marked ``admitted_late``; they move
        to in-flight like any flush, so :meth:`unfinished` never dips.
        Non-blocking; returns [] when nothing matches (or the batcher
        is closed — a drain must not grow forming batches)."""
        if limit <= 0:
            return []
        with self._cond:
            if self._closed or not self._pending:
                return []
            take, keep = [], []
            for req in self._pending:
                if req.task == task and len(take) < limit:
                    take.append(req)
                else:
                    keep.append(req)
            if not take:
                return []
            self._pending = keep
            self._inflight += len(take)
            now = self._clock()
            for req in take:
                req.dequeued_at = now
                req.admitted_late = True
            return take

    def depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def inflight(self) -> int:
        """Requests popped (flushed or late-admitted) but not yet
        finished — the in-flight half of :meth:`unfinished`, spanning
        every pipeline stage (forming, staged, executing, completing)."""
        with self._lock:
            return self._inflight

    def unfinished(self) -> int:
        """Pending + in-flight: the requests the service still OWES an
        answer. This — not :meth:`depth` — is what a graceful drain
        waits on (depth alone reads 0 while a popped batch is being
        processed, and its plan leftovers may be about to requeue), and
        what the router's least-loaded score balances on
        (``bert_serve_unfinished`` — a mid-batch replica must not
        scrape as idle). In pipelined dispatch the in-flight half spans
        every stage: requests in the forming batch, the staged handoff,
        the executing batch, and the completion stage all count until
        :meth:`done` retires them."""
        with self._lock:
            return len(self._pending) + self._inflight

    def drain_remaining(self) -> List[Request]:
        """Pop and return every still-pending request (drain-deadline
        path, serve/service.py stop): the caller fails them
        deterministically instead of leaving their submitters blocked
        until the client-side timeout."""
        with self._cond:
            remaining, self._pending = self._pending, []
            self._cond.notify_all()
        return remaining
