"""ServingService — the dispatch plane tying Batcher, InferenceEngine,
and ServeTelemetry together (docs/serving.md "Continuous batching").

HTTP worker threads (or the offline batch scorer) call :meth:`submit`:
the payload is preprocessed on the calling thread (tokenization
parallelizes across workers — the tokenizers are thread-safe, see
data/tokenization.py), enqueued, and the caller blocks until the
dispatch plane fulfils the request.

Two dispatch modes (``--dispatch_mode``):

* **pipelined** (default) — continuous batching in the Orca
  iteration-level-scheduling lineage (Yu et al., OSDI 2022), adapted to
  the one-shot encoder workload. Three stages, each its own thread:

  - the **assembler** does host-only work: it pops flushed groups, plans
    them (bucket choice, FFD packing), stages the fixed-shape arrays,
    and — while the executor is busy and the staged handoff is full —
    keeps the batch it is FORMING open to late admission
    (:meth:`Batcher.admit_into_forming`): requests that arrive while
    batch N executes join batch N+1's plan up to the bucket/pack budget
    instead of waiting for the next flush;
  - the **executor** is the ONLY thread that touches the device (the
    one-device-thread invariant; the serving mirror of the
    DevicePrefetcher discipline): it consumes fully-staged plans from a
    depth-1 handoff, so back-to-back jitted forwards run with no
    assembly gap — the executor-gap (device-idle) share is measured and
    exported;
  - the **completion** stage demultiplexes (host conversion) and runs
    handler postprocess, so client decode never blocks the next device
    step.

* **serial** — the pre-pipeline flush-then-wait loop (one thread plans,
  packs, executes, and postprocesses in strict sequence), kept for A/B
  measurement and offline scoring via :meth:`process_batch`.

One device thread is deliberate in both modes: JAX dispatch is not
thread-safe-fast, and a single consumer keeps batches maximal.
Concurrency lives in the HTTP layer (many blocked submitters), the host
pipeline stages, and on the device (the batch).

Shutdown is a graceful DRAIN (docs/fault_tolerance.md): :meth:`stop`
first flips the service to draining — new submissions shed with
:class:`ServiceDraining` (the HTTP layer's 503, so load balancers stop
routing on the next health probe) — then waits on
:meth:`Batcher.unfinished` (pending + in-flight across EVERY pipeline
stage) before stopping the stage threads. Whatever is still inside the
plane then gets a deterministic outcome: batches the executor already
finished are FLUSHED (the answers exist — demux + postprocess run on
the stopping thread), everything staged-but-unexecuted, still forming,
or still pending is FAILED immediately. In-flight clients get answers,
not resets.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Callable, Dict, List, Optional

from bert_pytorch_tpu_torch.serve.batcher import Batcher, Request
# One source of truth for the mode names: the CLI surface (argparse
# choices) and this constructor's validation must never drift.
from bert_pytorch_tpu_torch.serve.cli import DISPATCH_MODES
from bert_pytorch_tpu_torch.serve.engine import (InferenceEngine,
                                                 SwapUnsupported)
from bert_pytorch_tpu_torch.serve.stats import ServeTelemetry
from bert_pytorch_tpu_torch.serve.tracing import TraceCollector
from bert_pytorch_tpu_torch.testing import faults


class ServiceDraining(RuntimeError):
    """Submission rejected: the service is draining for shutdown (the
    HTTP layer maps this to 503, like :class:`~bert_pytorch_tpu_torch.serve.
    batcher.BatcherFull` overload shedding)."""


class _Executed:
    """One executed batch in flight between the executor and completion
    stages: the staged batch, its device output (or the execute error),
    and the executor's timing — ``gap_s`` is the device-idle gap since
    the previous forward ended (None for the first batch)."""

    def __init__(self, staged, out, info, error, exec_start, exec_done,
                 gap_s):
        self.staged = staged
        self.out = out
        self.info = info
        self.error = error
        self.exec_start = exec_start
        self.exec_done = exec_done
        self.gap_s = gap_s


class ServingService:
    def __init__(
        self,
        engine: InferenceEngine,
        batcher: Batcher,
        telemetry: Optional[ServeTelemetry] = None,
        tracer: Optional[TraceCollector] = None,
        heartbeat=None,
        heartbeat_interval_s: float = 1.0,
        capture=None,
        clock: Callable[[], float] = time.monotonic,
        dispatch_mode: str = "pipelined",
    ):
        """``tracer`` enables request-level span tracing + the /metricsz
        export (serve/tracing.py); None skips all trace bookkeeping (the
        overhead guard's baseline). NOTE: phase spans subtract
        timestamps the batcher stamped, so a tracer-carrying service and
        its batcher must share one ``clock`` (both default to
        ``time.monotonic``). ``heartbeat`` is an optional
        :class:`~bert_pytorch_tpu_torch.telemetry.sentinels.Heartbeat` the
        dispatch plane beats at most every ``heartbeat_interval_s`` (the
        completion stage in pipelined mode — the thread whose progress
        means clients are getting answers) — the same resumable liveness
        file the training runners write, so the capture harness covers
        serving processes too. ``capture`` is an optional
        :class:`~bert_pytorch_tpu_torch.telemetry.sampler.CaptureController`
        (``POST /profilez`` arms it via serve/http.py; the thread that
        runs the forwards ticks it between them, with position =
        requests served). ``dispatch_mode`` selects the pipelined
        continuous-batching plane (default) or the serial
        flush-then-wait loop (module docstring)."""
        if dispatch_mode not in DISPATCH_MODES:
            raise ValueError(
                f"dispatch_mode must be one of {DISPATCH_MODES}, got "
                f"{dispatch_mode!r}")
        self.engine = engine
        self.batcher = batcher
        self.telemetry = telemetry or ServeTelemetry()
        self.tracer = tracer
        self.dispatch_mode = dispatch_mode
        if tracer is not None:
            # /statsz then carries the run-level phase rollup, keeping
            # one scrape surface consistent with /metricsz.
            self.telemetry.attach_tracer(tracer)
        self._heartbeat = heartbeat
        self._heartbeat_interval_s = float(heartbeat_interval_s)
        # Frozen binding (concurrency registry): HTTP workers arm it,
        # the dispatch plane ticks it; the controller locks itself.
        self.capture = capture
        self._clock = clock
        # Guards _threads, _draining, _forming, and _stage_inflight (the
        # concurrency registry, analysis/concurrency.py, enforced by
        # jaxlint LK501): begin_drain runs on a signal-handling/main
        # thread, every HTTP worker reads _draining in submit and thread
        # liveness in /healthz, the stage threads update their in-flight
        # markers, and /metricsz reads the forming-depth gauge.
        self._state_lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._draining = False
        # Pipelined-plane state. The queues and the hunger event are
        # bound once and never rebound (frozen; Queue/Event lock
        # themselves). The depth-1 handoff plus the executor's hunger
        # signal are what make the admission window real: the assembler
        # keeps its forming batch OPEN to late admission until the
        # executor is actually waiting (or the batch is full), so a
        # batch is never frozen partial while the device is busy.
        self._handoff: "queue_mod.Queue" = queue_mod.Queue(maxsize=1)
        self._completed_q: "queue_mod.Queue" = queue_mod.Queue()
        self._hungry = threading.Event()
        self._forming = 0                    # forming-batch depth gauge
        self._stage_inflight: Dict[str, object] = {}
        # How long a blocked handoff put waits before re-checking the
        # admission window for newly-arrived requests.
        self._admit_poll_s = 0.002
        # Confined to the assembler thread: the admit_hold chaos hook's
        # batch counter (testing/faults.py).
        self._batches_assembled = 0
        # Confined to the single device-calling thread (serial dispatch
        # thread; the pipelined executor keeps its own local): when the
        # previous forward ended, for the executor-gap measurement.
        self._last_exec_end: Optional[float] = None

    # -- request side ----------------------------------------------------

    def submit(self, task: str, payload: dict,
               timeout: Optional[float] = 30.0,
               trace_ctx: Optional[dict] = None) -> dict:
        """Prepare, enqueue, and wait for one request; returns the task
        handler's JSON-able result. Raises ValueError for bad payloads /
        unknown tasks, TimeoutError when the deadline passes,
        ServiceDraining once shutdown has begun. ``trace_ctx`` is the
        inbound router trace context (serve/http.py parses the
        ``X-Bert-Trace`` header) forwarded to the tracer so fleet-wide
        sampling stays consistent."""
        with self._state_lock:
            draining = self._draining
        if draining:
            raise ServiceDraining(
                "service is draining for shutdown; not accepting requests")
        spec = self.engine.tasks.get(task)
        if spec is None:
            raise ValueError(
                f"unknown task {task!r}; serving: "
                f"{sorted(self.engine.tasks)}")
        t_prep0 = self._clock()
        features = spec.handler.prepare(payload, self.engine.max_len())
        request = Request(task, features, payload)
        request.prepare_s = self._clock() - t_prep0
        request.trace_ctx = trace_ctx
        self.batcher.submit(request)
        if not request.wait(timeout):
            # Nobody will read the result: let the dispatch plane skip
            # the forward instead of spending device time on it.
            request.abandoned = True
            self.telemetry.observe_error()
            if self.tracer is not None:
                self.tracer.observe_error(task)
            raise TimeoutError(f"request timed out after {timeout}s")
        if request.error is not None:
            raise RuntimeError(request.error)
        return request.result

    # -- serial dispatch (A/B baseline, offline scoring, tests) ----------

    def process_batch(self, batch: List[Request]) -> None:
        """Plan, execute, demultiplex, postprocess, observe one flushed
        group in strict sequence (callable directly for deterministic
        tests and offline scoring — the serial background thread just
        loops it).

        With a tracer attached, each completed request is decomposed
        into the serve/tracing.py span taxonomy: ``queue`` (enqueue ->
        batcher pop), ``assembly`` (pop -> device dispatch: planning,
        bucket choice, packing/padding, plus the demux host conversion),
        ``execute`` (the batch's jitted forward incl. device sync,
        shared), and ``postprocess`` (the request's own handler decode).
        (Pipelined dispatch measures the same taxonomy per stage — see
        :meth:`_complete` for its assembly semantics.)
        """
        popped = len(batch)
        requeued = 0
        try:
            requeued = self._process_batch(batch)
        finally:
            # Everything popped that was not requeued is finished
            # (result, error, or abandoned-and-skipped) — the batcher's
            # in-flight accounting is what a graceful drain waits on
            # (Batcher.unfinished; the requeue-during-drain fix).
            self.batcher.done(popped - requeued)

    def _process_batch(self, batch: List[Request]) -> int:
        """The serial dispatch body; returns how many requests were
        requeued as plan leftovers (the in-flight bookkeeping in the
        wrapper)."""
        batch = [r for r in batch if not r.abandoned]
        if not batch:
            return 0
        entry = self._clock()
        for req in batch:
            if req.enqueued_at is None:
                # Directly-constructed requests (offline scoring, tests)
                # never passed through Batcher.submit/pop — anchor their
                # life at batch entry so e2e latency and trace spans
                # measure this call, not clock-origin process uptime
                # (which would also force-trace every one as over-SLO).
                req.enqueued_at = req.dequeued_at = entry
        task = batch[0].task
        spec = self.engine.tasks[task]
        plan = self.engine.plan_batch(batch)
        requeued = len(plan.leftover)
        if plan.leftover:
            self.batcher.requeue_front(plan.leftover)
        try:
            staged = self.engine.stage(task, plan)
            exec_start = self._clock()
            out, info = self.engine.execute_staged(staged)
            exec_end = self._clock()
            outputs = self.engine.demux(staged, out)
        except Exception as exc:  # fulfil waiters; the server stays up
            now = self._clock()
            for req in plan.requests:
                req.set_error(f"{type(exc).__name__}: {exc}", now)
                self.telemetry.observe_error()
                if self.tracer is not None:
                    self.tracer.observe_error(task)
            return requeued
        # Executor-gap measurement, serial flavor: the device idles from
        # the end of the previous forward to the start of this one
        # (assembly, demux, and postprocess all sit in that gap — the
        # idle the pipelined plane exists to squeeze out).
        gap_s = (exec_start - self._last_exec_end
                 if self._last_exec_end is not None else None)
        self._last_exec_end = exec_end
        exec_done = self._clock()
        device_s = info["device_s"]
        budget = info["rows"] * info["bucket"]
        occupancy = (info["real_tokens"] / budget) if budget else None
        e2e = []
        now = exec_done
        for req, out in zip(plan.requests, outputs):
            # Fresh read, not the previous iteration's `now`: the prior
            # request's tracer emit happens between iterations and must
            # not be attributed to THIS request's postprocess span.
            pp_start = self._clock()
            try:
                result = spec.handler.postprocess(
                    req.features, out, req.payload)
                now = self._clock()
                req.device_s = device_s
                req.set_result(result, now)
                total_s = now - req.enqueued_at
                e2e.append(total_s)
            except Exception as exc:
                now = self._clock()
                req.set_error(f"{type(exc).__name__}: {exc}", now)
                self.telemetry.observe_error()
                if self.tracer is not None:
                    self.tracer.observe_error(task)
                continue
            if self.tracer is None:
                continue
            try:
                # Outside the fulfilment try: the result is already
                # delivered, and a telemetry emit failure (sink closed
                # mid-shutdown, disk full) must not flip a fulfilled
                # request into the error path.
                queue_s = max(0.0, req.dequeued_at - req.enqueued_at)
                self.tracer.observe(
                    task, req.id,
                    phases_s={
                        "queue": queue_s,
                        # Everything between the pop and the forward
                        # returning that was not device time.
                        "assembly": max(
                            0.0, exec_done - req.dequeued_at - device_s),
                        "execute": device_s,
                        "postprocess": now - pp_start,
                    },
                    total_s=total_s,
                    bucket=info["bucket"],
                    packed=info["packed"],
                    batch_requests=len(plan.requests),
                    occupancy=occupancy,
                    prepare_s=req.prepare_s,
                    pack_s=info.get("pack_s"),
                    admitted_late=req.admitted_late,
                    trace_ctx=req.trace_ctx,
                )
            except Exception:
                pass  # observability must never break serving
        if e2e:
            self.telemetry.observe_batch(
                e2e_s=e2e,
                device_s=device_s,
                rows=info["rows"],
                bucket=info["bucket"],
                real_tokens=info["real_tokens"],
                queue_depth=self.batcher.depth(),
                compiles=info["compiles"],
                exec_gap_s=gap_s,
            )
        return requeued

    def _loop(self) -> None:
        # last_beat stays a local: heartbeat cadence state is owned by
        # this thread alone (the Heartbeat binding itself is frozen
        # after __init__ — concurrency registry).
        last_beat = 0.0
        while not self._stop.is_set():
            batch = self.batcher.next_batch(timeout=0.1)
            if batch:
                self.process_batch(batch)
                # Chaos hook (testing/faults.py `wedge@N`): after N
                # served requests this call never returns — the
                # dispatch thread hangs with /healthz still answering
                # 200, which is exactly the failure only the
                # supervisor's heartbeat watchdog can catch. Inert
                # (one dict lookup) unless a fault spec is armed.
                faults.get_plan().serve_wedge_check(
                    self.telemetry.request_count(),
                    emit=self.telemetry.emit)
            last_beat = self._maybe_beat(last_beat)
            self._capture_tick()

    # -- pipelined dispatch: assembler / executor / completion -----------

    def _set_forming(self, depth: int) -> None:
        with self._state_lock:
            self._forming = int(depth)

    def _note_stage_inflight(self, stage: str, item) -> None:
        """Track the batch a stage thread is currently holding so a
        drain that outlives the join grace can fail its requests
        deterministically (stop -> _drain_pipeline)."""
        with self._state_lock:
            if item is None:
                self._stage_inflight.pop(stage, None)
            else:
                self._stage_inflight[stage] = item

    def _assemble_loop(self) -> None:
        """Assembler stage: pop -> plan -> stage, host-only. The batch
        being formed stays OPEN to late admission for as long as the
        executor is busy: newly arrived same-task requests are admitted
        into it — up to the bucket/pack budget — and the plan is
        re-staged (host work, overlapped with the running forward). The
        batch is handed off only when the executor signals hunger (it
        is waiting RIGHT NOW, so the pre-staged arrays cross the
        depth-1 handoff with no assembly gap) or when it reaches the
        flush budget (a full batch parks in the handoff early — it
        cannot grow anyway, and parking frees this stage to form the
        next one). That window is continuous batching's whole point: a
        request that lands mid-execute rides the NEXT device step, not
        the one after — and no partial batch is ever frozen while the
        device is busy (a frozen partial batch still costs a full
        fixed-shape forward)."""
        while not self._stop.is_set():
            group = self.batcher.next_batch(timeout=0.05)
            if not group:
                continue
            live = [r for r in group if not r.abandoned]
            if len(live) < len(group):
                self.batcher.done(len(group) - len(live))
            if not live:
                continue
            self._form_and_hand_off(live)
            self._set_forming(0)

    def _form_and_hand_off(self, live: List[Request]) -> None:
        """The admission window for one popped group: plan, stage,
        admit, re-stage, and hand off on executor hunger or a full
        budget. Owns every outcome for the group's requests: handed to
        the executor, requeued when stop() closes the window first, or
        failed deterministically when planning/staging raises (the
        serial loop fails the batch and keeps serving — so does this
        stage; a dead assembler would strand requests in in-flight
        accounting with no queue to sweep them from)."""
        task = live[0].task
        plan = None
        # Admitted requests the re-plan has not absorbed yet: if the
        # re-plan itself raises, these are in-flight (their submitters
        # are blocked, the batcher counted them) but in NO plan — the
        # exception handler must fail them too or they leak until the
        # client-side timeout and permanently inflate unfinished().
        admitted_unmerged: List[Request] = []
        try:
            plan = self.engine.plan_batch(live)
            if plan.leftover:
                self.batcher.requeue_front(plan.leftover)
            self._set_forming(len(plan.requests))
            self._batches_assembled += 1
            # Chaos hook (testing/faults.py `admit_hold@N`): hold the
            # admission window open on the Nth formed batch so the
            # chaos harness can SIGKILL this replica with requests
            # provably inside the forming batch. Inert unless armed.
            faults.get_plan().serve_admit_check(
                self._batches_assembled, emit=self.telemetry.emit)
            staged = None
            admit_open = True
            while not self._stop.is_set():
                if staged is None:
                    staged = self.engine.stage(task, plan)
                    staged.staged_at = self._clock()
                full = len(plan.requests) >= self.batcher.flush_size()
                if self._hungry.is_set() or full:
                    try:
                        self._handoff.put(staged,
                                          timeout=self._admit_poll_s)
                        return
                    except queue_mod.Full:
                        # A full batch is already parked and the
                        # executor has not taken it yet; fall through
                        # to the admission window below.
                        pass
                if not admit_open:
                    self._hungry.wait(timeout=self._admit_poll_s)
                    continue
                # Admission window: the executor is busy — anything
                # arriving NOW joins THIS forming plan instead of
                # waiting for its own flush.
                room = self.batcher.flush_size() - len(plan.requests)
                admitted = self.batcher.admit_into_forming(task, room)
                if not admitted:
                    # Nothing new: hold the window open a beat — waking
                    # INSTANTLY if the executor goes hungry, so the
                    # pre-staged batch crosses the handoff with no
                    # assembly gap.
                    self._hungry.wait(timeout=self._admit_poll_s)
                    continue
                fresh = [r for r in admitted if not r.abandoned]
                if len(fresh) < len(admitted):
                    self.batcher.done(len(admitted) - len(fresh))
                if not fresh:
                    continue
                admitted_unmerged = fresh
                replanned = self.engine.plan_batch(plan.requests + fresh)
                if replanned.leftover:
                    # The re-plan could not place everything (packed
                    # rows full below the request budget): give the
                    # overflow back and CLOSE the window — admitting
                    # again would just pop the same requests into the
                    # same leftover, a re-stage spin that burns the
                    # assembler until the executor goes hungry
                    # (requeue_front clears their admitted_late marker;
                    # a future flush serves them).
                    self.batcher.requeue_front(replanned.leftover)
                    admit_open = False
                if replanned.requests != plan.requests:
                    staged = None  # re-stage with the admitted requests
                plan = replanned
                admitted_unmerged = []
                self._set_forming(len(plan.requests))
            # stop() raced the handoff: give the forming batch back so
            # the drain path fails (or a restart serves) it
            # deterministically instead of dropping it on the floor.
            self.batcher.requeue_front(plan.requests)
        except Exception as exc:
            self._fail_batch(
                (plan.requests if plan is not None else live)
                + admitted_unmerged,
                f"{type(exc).__name__}: {exc}")

    def _execute_loop(self) -> None:
        """Executor stage: the ONLY thread that touches the device.
        Consumes fully-staged plans from the depth-1 handoff so
        back-to-back jitted forwards run with no assembly gap; the gap
        that remains (handoff empty — the assembler could not keep up,
        or there was no traffic) is measured and exported as the
        device-idle share."""
        last_end: Optional[float] = None
        while True:
            # On-demand capture boundary between forwards: the profiler
            # starts and stops on the thread that launches the kernels,
            # so the trace holds its operator events as well as the
            # card's kernels, and whole forwards only.
            self._capture_tick()
            # Hunger signal: tells the assembler "hand me your forming
            # batch NOW" — admission closes for that batch the moment
            # the device is actually ready for it, not a deadline
            # earlier (cleared below while a forward runs).
            self._hungry.set()
            try:
                staged = self._handoff.get(timeout=0.05)
            except queue_mod.Empty:
                if self._stop.is_set():
                    return
                continue
            self._hungry.clear()
            self._note_stage_inflight("executor", staged)
            exec_start = self._clock()
            gap_s = (exec_start - last_end) if last_end is not None else None
            try:
                out, info = self.engine.execute_staged(staged)
                error = None
            except Exception as exc:
                out, info = None, None
                error = f"{type(exc).__name__}: {exc}"
            exec_done = self._clock()
            last_end = exec_done
            self._completed_q.put(_Executed(
                staged, out, info, error, exec_start, exec_done, gap_s))
            self._note_stage_inflight("executor", None)

    def _complete_loop(self) -> None:
        """Completion stage: demux (host conversion) + handler
        postprocess + fulfilment + telemetry, off the device thread.
        Beats the heartbeat (progress here means clients are getting
        answers) and carries the wedge chaos hook the serial loop had —
        a wedged completion stage is exactly the healthz-still-200
        failure only the supervisor's watchdog can catch."""
        last_beat = 0.0
        while True:
            try:
                done = self._completed_q.get(timeout=0.05)
            except queue_mod.Empty:
                if self._stop.is_set():
                    return
                last_beat = self._maybe_beat(last_beat)
                continue
            self._note_stage_inflight("completion", done)
            self._complete(done)
            self._note_stage_inflight("completion", None)
            faults.get_plan().serve_wedge_check(
                self.telemetry.request_count(),
                emit=self.telemetry.emit)
            last_beat = self._maybe_beat(last_beat)

    def _complete(self, done: _Executed) -> None:
        """Finish one executed batch: demux, postprocess, fulfil,
        observe. Pipelined span semantics (docs/serving.md): ``queue``
        = enqueue -> pop/admission, ``assembly`` = pop -> staging
        complete (planning + packing + padding, the host work actually
        done FOR this batch), ``execute`` = the jitted forward incl.
        sync, ``postprocess`` = the request's own handler decode. The
        staged-handoff wait (staging complete -> executor pickup) and
        the completion-queue wait are pipeline buffering, not work —
        they ride sampled traces as ``staged_wait_ms`` context, and the
        span-sum invariant (sum <= total) holds by construction because
        every span is a disjoint sub-interval of the request's life."""
        staged, info = done.staged, done.info
        plan = staged.plan
        task = staged.task
        if done.error is not None:
            now = self._clock()
            for req in plan.requests:
                req.set_error(done.error, now)
                self.telemetry.observe_error()
                if self.tracer is not None:
                    self.tracer.observe_error(task)
            self.batcher.done(len(plan.requests))
            return
        spec = self.engine.tasks[task]
        try:
            # Same contract as the serial loop's execute try: a demux
            # failure (host conversion of a malformed device output)
            # fails THIS batch's requests and keeps the stage serving —
            # it must never kill the completion thread.
            outputs = self.engine.demux(staged, done.out)
        except Exception as exc:
            self._fail_batch(plan.requests,
                             f"{type(exc).__name__}: {exc}")
            return
        device_s = info["device_s"]
        budget = info["rows"] * info["bucket"]
        occupancy = (info["real_tokens"] / budget) if budget else None
        staged_at = staged.staged_at if staged.staged_at is not None \
            else done.exec_start
        staged_wait_s = max(0.0, done.exec_start - staged_at)
        # Late-admission count over the requests that actually produce
        # an e2e sample: observe_batch's window_requests basis excludes
        # postprocess failures, and the schema lint holds
        # admitted_late <= window_requests.
        n_late = 0
        e2e = []
        now = done.exec_done
        for req, out in zip(plan.requests, outputs):
            pp_start = self._clock()
            try:
                result = spec.handler.postprocess(
                    req.features, out, req.payload)
                now = self._clock()
                req.device_s = device_s
                req.set_result(result, now)
                total_s = now - req.enqueued_at
                e2e.append(total_s)
                if req.admitted_late:
                    n_late += 1
            except Exception as exc:
                now = self._clock()
                req.set_error(f"{type(exc).__name__}: {exc}", now)
                self.telemetry.observe_error()
                if self.tracer is not None:
                    self.tracer.observe_error(task)
                continue
            if self.tracer is None:
                continue
            try:
                queue_s = max(0.0, req.dequeued_at - req.enqueued_at)
                self.tracer.observe(
                    task, req.id,
                    phases_s={
                        "queue": queue_s,
                        # Host work done for this batch after this
                        # request joined it (plan + pack + pad; a
                        # late-admitted request only pays the re-stage).
                        "assembly": max(0.0, staged_at - req.dequeued_at),
                        "execute": device_s,
                        "postprocess": now - pp_start,
                    },
                    total_s=total_s,
                    bucket=info["bucket"],
                    packed=info["packed"],
                    batch_requests=len(plan.requests),
                    occupancy=occupancy,
                    prepare_s=req.prepare_s,
                    pack_s=info.get("pack_s"),
                    admitted_late=req.admitted_late,
                    staged_wait_s=staged_wait_s,
                    trace_ctx=req.trace_ctx,
                )
            except Exception:
                pass  # observability must never break serving
        if e2e:
            self.telemetry.observe_batch(
                e2e_s=e2e,
                device_s=device_s,
                rows=info["rows"],
                bucket=info["bucket"],
                real_tokens=info["real_tokens"],
                queue_depth=self.batcher.depth(),
                compiles=info["compiles"],
                admitted_late=n_late,
                exec_gap_s=done.gap_s,
            )
        self.batcher.done(len(plan.requests))

    def _capture_tick(self) -> None:
        """On-demand capture boundary (telemetry/sampler.py): starts an
        armed capture, collects an expired one, on the thread that runs
        the forwards — the serial dispatch thread, or the executor stage
        in pipelined mode (the JAX service ticks on the completion stage;
        a ``torch.profiler`` started there records none of the executor's
        operator events) — with position = requests served
        (``covered_unit: "requests"``)."""
        if self.capture is not None:
            self.capture.tick(self.telemetry.request_count())

    def _maybe_beat(self, last_beat: float) -> float:
        if self._heartbeat is None:
            return last_beat
        now = self._clock()
        if now - last_beat >= self._heartbeat_interval_s:
            # step = requests served so far: the serving analog of the
            # training step counter the harness reads.
            self._heartbeat.beat(self.telemetry.request_count())
            return now
        return last_beat

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if not self.engine.warmed:
            self.engine.warmup()
        # One serve_cold_start record per engine start: how long warmup
        # took and how many compiles were real vs persistent-cache hits
        # (docs/serving.md "Inference fast path"); also lands in /statsz.
        # getattr: test fakes (and pre-warmed engines from older callers)
        # may not carry startup stats — a missing record beats a crash.
        self.telemetry.observe_cold_start(
            getattr(self.engine, "startup", None))
        self.telemetry.reset_clock()  # rps measures serving, not warmup
        if self._heartbeat is not None:
            # First beat before any traffic: liveness is visible the
            # moment the dispatch plane exists, not after the first
            # request (the training runners beat from step 1 onward).
            self._heartbeat.beat(self.telemetry.request_count())
        self._stop.clear()
        if self.dispatch_mode == "pipelined":
            targets = (("serve-assembler", self._assemble_loop),
                       ("serve-executor", self._execute_loop),
                       ("serve-completion", self._complete_loop))
        else:
            targets = (("serve-dispatch", self._loop),)
        threads = [threading.Thread(target=fn, name=name, daemon=True)
                   for name, fn in targets]
        with self._state_lock:
            self._draining = False
            self._threads = threads
        for thread in threads:
            thread.start()

    # -- hot swap ----------------------------------------------------------

    def serving_version(self) -> Optional[str]:
        """The engine's serving model version (getattr: test fakes may
        not carry the swap plumbing — None then, and the version fields
        simply stay off the surfaces)."""
        version = getattr(self.engine, "version", None)
        return version() if callable(version) else None

    def swap(self, task: str, checkpoint: str, version: str) -> dict:
        """Hot-swap one task to ``checkpoint`` as ``version`` (the
        /swapz control endpoint, docs/serving.md "Model registry &
        canary rollouts"). Runs on the calling (HTTP control) thread —
        the load happens off the dispatch path and only the atomic flip
        touches state the executor reads; in-flight batches complete
        against the old version. Raises engine.SwapBusy when a swap is
        already in flight (HTTP 409), and engine.SwapUnsupported when the
        engine has no ``swap_params`` (HTTP 404)."""
        swap_params = getattr(self.engine, "swap_params", None)
        if not callable(swap_params):
            raise SwapUnsupported(
                "hot-swap unsupported: this server's engine has no "
                "swap_params")
        return swap_params(task, checkpoint, version,
                           emit=self.telemetry.emit)

    # -- health / drain ----------------------------------------------------

    @property
    def draining(self) -> bool:
        with self._state_lock:
            return self._draining

    @property
    def dispatch_alive(self) -> bool:
        """True while EVERY stage thread of the dispatch plane exists
        and is running — the liveness /healthz must report (an HTTP
        thread answering proves nothing about the threads that actually
        serve results, and a dead executor with a live assembler is
        still a dead replica)."""
        with self._state_lock:
            threads = list(self._threads)
        return bool(threads) and all(t.is_alive() for t in threads)

    def health(self) -> dict:
        """Liveness snapshot for /healthz (serve/http.py): ``ok`` only
        when every stage thread is alive and not draining — anything
        else is a 503 so load balancers stop routing here. One lock
        acquisition reads a CONSISTENT (draining, threads) set — the
        status string and the boolean fields must not disagree
        mid-drain. ``unfinished`` (pending + in-flight across every
        stage) rides along so a scraper without /metricsz still sees
        the honest load signal (queue_depth alone reads 0 the instant a
        batch pops)."""
        with self._state_lock:
            draining = self._draining
            threads = list(self._threads)
            forming = self._forming
        alive = bool(threads) and all(t.is_alive() for t in threads)
        if draining:
            status = "draining"
        elif alive:
            status = "ok"
        else:
            status = "not_serving"  # never started, or a stage died
        health = {
            "status": status,
            "dispatch_alive": alive,
            "draining": draining,
            "dispatch_mode": self.dispatch_mode,
            "queue_depth": self.batcher.depth(),
            "unfinished": self.batcher.unfinished(),
        }
        version = self.serving_version()
        if version is not None:
            # The serving model version rides /healthz too: chaos
            # replicas run without a tracer (no /metricsz), and the
            # router's scrape fallback must still learn the version
            # (serve/router.py default_scrape).
            health["version"] = version
        if self.dispatch_mode == "pipelined":
            health["stages"] = {
                t.name.replace("serve-", "", 1): t.is_alive()
                for t in threads}
            health["forming_depth"] = forming
        return health

    def begin_drain(self) -> None:
        """Flip to draining: new submissions shed with ServiceDraining /
        HTTP 503; already-accepted requests keep being served. Called at
        the start of :meth:`stop` (or earlier, by a signal handler that
        wants health probes failing before the HTTP listener closes)."""
        with self._state_lock:
            self._draining = True

    def stop(self, drain_s: float = 2.0, join_s: float = 5.0) -> None:
        """Graceful drain: stop accepting, flush already-accepted
        requests for up to ``drain_s`` seconds, stop the stage threads
        (each given ``join_s`` to exit), fail-or-flush whatever is still
        inside the pipeline, flush the serve telemetry summary.

        The drain waits on :meth:`Batcher.unfinished` (pending PLUS
        in-flight across EVERY stage — forming batch, staged handoff,
        executing batch, completion queue), not queue depth: depth reads
        0 the moment a batch is popped. Any request still unserved when
        the drain deadline passes (or when a stage is dead/stuck) is
        failed DETERMINISTICALLY; batches the executor already finished
        are flushed — their answers exist, so their clients get them."""
        self.begin_drain()
        deadline = self._clock() + drain_s
        while self.batcher.unfinished() and self._clock() < deadline:
            if not self.dispatch_alive:
                break  # nobody is left to finish them; fail them below
            time.sleep(0.01)
        self._stop.set()
        self.batcher.close()
        # Detach under the lock, join OUTSIDE it: holding _state_lock
        # through the joins would block every /healthz probe mid-shutdown.
        with self._state_lock:
            threads, self._threads = self._threads, []
        for thread in threads:
            thread.join(timeout=join_s)
        # Deterministic fail-or-flush for everything the stage threads
        # never got to (drain deadline passed, a stage died, or a stage
        # is wedged past the join grace): blocked submitters wake NOW
        # with a definite answer instead of timing out client-side.
        self._drain_pipeline()
        stranded = self.batcher.drain_remaining()
        if stranded:
            self._fail_requests(
                stranded,
                "service stopped before this request was dispatched "
                "(drain deadline)")
        if self.capture is not None and all(
                not t.is_alive() for t in threads):
            # A capture still running is collected over the requests it
            # saw (its boundary's owner is gone), so its trace is written
            # and the profiler released before the telemetry summary.
            self.capture.tick(self.telemetry.request_count(), force=True)
        self.telemetry.finish()  # also flushes the attached tracer
        if self._heartbeat is not None and all(
                not t.is_alive() for t in threads):
            # Final beat only once the stage threads are provably gone:
            # Heartbeat.beat is not thread-safe (it relies on the thread
            # lifecycle for serialization), and a join that timed out
            # would leave a loop free to beat concurrently — skipping
            # one last beat beats tearing the liveness file.
            self._heartbeat.beat(self.telemetry.request_count())

    def _drain_pipeline(self) -> None:
        """Stop-time sweep of the pipelined plane (a no-op in serial
        mode — both queues are empty). Executed-but-undelivered batches
        are FLUSHED (demux + postprocess on this thread); batches a
        wedged stage still holds, and staged-but-unexecuted batches, are
        FAILED. Ordering matters: the stage in-flight MARKERS are swept
        FIRST — the executor puts its result into the completed queue
        BEFORE clearing its marker, so any batch absent from the
        markers is either fully retired or already visible in the
        queue, and draining the queue last closes the window where an
        executor running past the join grace slips a finished batch
        between the two sweeps. A wedged stage waking later and
        double-finishing is harmless: fulfilment events are already
        set, and the batcher's in-flight counter clamps at zero."""
        with self._state_lock:
            inflight = dict(self._stage_inflight)
            self._stage_inflight.clear()
        comp = inflight.get("completion")
        if comp is not None:
            self._fail_batch(
                comp.staged.plan.requests,
                "service stopped while this request was in the "
                "completion stage (drain deadline)")
        executing = inflight.get("executor")
        if executing is not None:
            self._fail_batch(
                executing.plan.requests,
                "service stopped while this request's batch was "
                "executing (drain deadline)")
        while True:
            try:
                done = self._completed_q.get_nowait()
            except queue_mod.Empty:
                break
            if done is comp or (executing is not None
                                and done.staged is executing):
                # This batch was in the queue AND still marked (the
                # executor put it, then wedged before clearing): the
                # marker sweep above already failed and retired it.
                continue
            self._complete(done)
        while True:
            try:
                staged = self._handoff.get_nowait()
            except queue_mod.Empty:
                break
            self._fail_batch(
                staged.plan.requests,
                "service stopped with this request staged but "
                "unexecuted (drain deadline)")

    def _fail_batch(self, requests: List[Request], message: str) -> None:
        """Fail every still-unanswered request of one stranded batch and
        retire the whole batch from the in-flight accounting."""
        self._fail_requests(
            [r for r in requests if r.completed_at is None], message)
        self.batcher.done(len(requests))

    def _fail_requests(self, requests: List[Request], message: str) -> None:
        now = self._clock()
        for req in requests:
            req.set_error(message, now)
            self.telemetry.observe_error()
            if self.tracer is not None:
                self.tracer.observe_error(req.task)

    # -- metrics export ---------------------------------------------------

    def metrics_text(self) -> Optional[str]:
        """The full /metricsz payload (Prometheus text format): the
        tracer's per-task counters + phase histograms, then the
        service-level gauges a router wants in the same scrape — queue
        depth, the unfinished (pending + in-flight) load signal,
        forming-batch depth, dispatch liveness, device-idle share, run
        occupancy, cold-start cost. None when no tracer is attached
        (the HTTP layer 404s)."""
        if self.tracer is None:
            return None
        lines = [self.tracer.metrics_text().rstrip("\n")]
        # Base gauges only: the phases sub-object would recompute the
        # tracer's whole percentile rollup per scrape and be discarded.
        snap = self.telemetry.snapshot(include_phases=False)
        with self._state_lock:
            forming = self._forming

        def gauge(name, value, help_text):
            if value is None:
                return
            lines.append(f"# HELP bert_serve_{name} {help_text}")
            lines.append(f"# TYPE bert_serve_{name} gauge")
            lines.append(f"bert_serve_{name} {float(value):g}")

        gauge("queue_depth", self.batcher.depth(),
              "Requests pending in the batcher queue (reads 0 the "
              "instant a batch pops — balance on unfinished).")
        gauge("unfinished", self.batcher.unfinished(),
              "Requests pending + in-flight across every dispatch "
              "stage — the load signal the router balances and "
              "brownouts on.")
        gauge("forming_depth", forming,
              "Requests in the assembler's forming batch (the "
              "admission window).")
        gauge("dispatch_alive", 1.0 if self.dispatch_alive else 0.0,
              "1 while every dispatch-plane stage thread is running.")
        gauge("draining", 1.0 if self.draining else 0.0,
              "1 once shutdown drain has begun.")
        gauge("batch_occupancy", snap.get("batch_occupancy"),
              "Run-level real tokens / dispatched slot budget.")
        gauge("device_idle_share", snap.get("device_idle_share"),
              "Executor gap share: device idle between consecutive "
              "forwards / (idle + busy).")
        gauge("cold_start_seconds", snap.get("cold_start_s"),
              "Engine AOT warmup wall time (serve_cold_start record).")
        gauge("warmup_compiles_cold", snap.get("warmup_compiles_cold"),
              "Real XLA compiles during warmup (0 = warm restart).")
        version = self.serving_version()
        if version is not None:
            # Label-valued gauge (value is always 1; the label carries
            # the version string) — the idiomatic Prometheus "info"
            # metric, and what the router's scrape parses.
            lines.append("# HELP bert_serve_serving_version The model "
                         "version this replica is serving (label).")
            lines.append("# TYPE bert_serve_serving_version gauge")
            lines.append(
                f'bert_serve_serving_version{{version="{version}"}} 1')
        return "\n".join(lines) + "\n"
