"""Serve-side telemetry: windowed latency/occupancy records + /statsz.

The ``serve`` record family (telemetry/schema.py) mirrors the training
layer's ``step_window``/``run_summary`` pair:

* ``kind="serve_window"`` — emitted every ``window`` completed requests:
  request count, end-to-end and on-device latency percentiles
  (p50/p95/p99, milliseconds), batch count, mean batch occupancy
  (real tokens / dispatched slot budget — the serving analog of
  ``padding_efficiency``), max queue depth, the number of XLA
  compiles observed in the window (zero in steady state — the engine
  AOT-compiles every (task, bucket) at startup), and two
  continuous-batching gauges (docs/serving.md "Continuous batching"):
  ``admitted_late`` (requests that joined a forming batch through the
  admission window) and ``device_idle_share`` (executor gap between
  consecutive forwards / (gap + busy) — the idle the pipelined
  dispatch plane exists to squeeze out, and the metric behind the
  "serve device idle share" report gate);
* ``kind="serve_summary"`` — the end-of-run rollup ``finish()`` emits,
  plus the live snapshot ``/statsz`` serves.

Records flow through the same JSONLHandler/schema machinery as training
telemetry, so ``tools/check_telemetry_schema.py`` lints them (p50 <= p95
<= p99, occupancy in (0, 1]) and ``telemetry-report`` summarizes and
baseline-diffs them (p95 latency gate).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, List, Optional

# Run-level percentile basis: the MOST RECENT this-many request samples.
# A long-running server at heavy traffic would otherwise grow its latency
# history without bound and sort it under the lock on every /statsz scrape
# (window records are exact — they reset per window).
RUN_SAMPLE_CAP = 8192


def _pctl(sorted_vals: List[float], frac: float) -> float:
    """Nearest-rank percentile of an already-sorted list (the step_timer
    convention)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              int(frac * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


def _latency_fields(prefix: str, seconds: List[float]) -> dict:
    s = sorted(seconds)
    return {
        f"{prefix}_p50_ms": round(_pctl(s, 0.50) * 1000.0, 3),
        f"{prefix}_p95_ms": round(_pctl(s, 0.95) * 1000.0, 3),
        f"{prefix}_p99_ms": round(_pctl(s, 0.99) * 1000.0, 3),
    }


class ServeTelemetry:
    """Accumulates per-batch serving observations; emits window records.

    Thread-safety: ``observe_batch`` is called by the single dispatch
    thread, but ``snapshot()`` is read by HTTP worker threads — one lock
    covers both. ``emit`` receives plain record dicts (a JSONLHandler's
    ``write_record``, or TrainTelemetry.emit); None disables emission
    while the in-memory rollup keeps working (/statsz, bench).
    """

    def __init__(self, emit: Optional[Callable[[dict], None]] = None,
                 window: int = 64,
                 clock: Callable[[], float] = time.monotonic):
        self.emit = emit
        self.window = max(1, int(window))
        self._clock = clock
        self._lock = threading.Lock()
        self._t0 = clock()
        # current window
        self._e2e: List[float] = []
        self._device: List[float] = []
        self._batches = 0
        self._real_tokens = 0
        self._budget_tokens = 0
        self._depth_max = 0
        self._compiles = 0
        self._admitted_late = 0
        # Executor-gap accounting: device idle seconds between
        # consecutive forwards vs the busy (forward) seconds they
        # bracket — only batches that carried a gap sample contribute
        # to the busy basis, so the share is a true ratio.
        self._gap_s = 0.0
        self._gap_busy_s = 0.0
        self._window_t0 = clock()
        # run totals; latency samples bounded to the RUN_SAMPLE_CAP most
        # recent so a long-lived server's memory and /statsz cost stay flat
        self.total_requests = 0
        self.total_batches = 0
        self.total_errors = 0
        self._run_e2e = collections.deque(maxlen=RUN_SAMPLE_CAP)
        self._run_device = collections.deque(maxlen=RUN_SAMPLE_CAP)
        self._run_real_tokens = 0
        self._run_budget_tokens = 0
        self._run_depth_max = 0
        self._run_compiles = 0
        self._run_admitted_late = 0
        self._run_gap_s = 0.0
        self._run_gap_busy_s = 0.0
        # Engine startup stats (cold_start_s, warm/cold compile split,
        # quantize mode, weight bytes): written once by observe_cold_start
        # on the thread that ran warmup, read by HTTP workers via
        # snapshot() for /statsz — same lock as the other rollup state
        # (concurrency registry, analysis/concurrency.py).
        self._cold_start: Optional[dict] = None
        # Optional request tracer (serve/tracing.py): attached once by
        # the service before dispatch starts, read by snapshot()/finish()
        # on scrape threads — guarded by the same lock (registry entry).
        self._tracer = None

    # -- producer --------------------------------------------------------

    def observe_batch(self, e2e_s: List[float], device_s: float,
                      rows: int, bucket: int, real_tokens: int,
                      queue_depth: int = 0, compiles: int = 0,
                      admitted_late: int = 0,
                      exec_gap_s: Optional[float] = None) -> None:
        """Record one dispatched batch: per-request end-to-end latencies,
        the batch's forward wall time (incl. device sync), its dispatched
        slot budget (``rows * bucket``), and the real tokens it carried.
        ``admitted_late`` counts the batch's requests that joined its
        forming plan through the admission window; ``exec_gap_s`` is the
        device-idle gap between the previous forward's end and this
        one's start (None for the first batch — no gap exists yet)."""
        budget = int(rows) * int(bucket)
        with self._lock:
            self._e2e.extend(e2e_s)
            self._device.append(device_s)
            self._batches += 1
            self._real_tokens += int(real_tokens)
            self._budget_tokens += budget
            self._depth_max = max(self._depth_max, int(queue_depth))
            self._compiles += int(compiles)
            self._admitted_late += int(admitted_late)
            if exec_gap_s is not None:
                gap = max(0.0, float(exec_gap_s))
                self._gap_s += gap
                self._gap_busy_s += float(device_s)
                self._run_gap_s += gap
                self._run_gap_busy_s += float(device_s)
            self.total_requests += len(e2e_s)
            self.total_batches += 1
            self._run_e2e.extend(e2e_s)
            self._run_device.append(device_s)
            self._run_real_tokens += int(real_tokens)
            self._run_budget_tokens += budget
            self._run_depth_max = max(self._run_depth_max,
                                      int(queue_depth))
            self._run_compiles += int(compiles)
            self._run_admitted_late += int(admitted_late)
            due = len(self._e2e) >= self.window
        if due:
            self.flush_window()

    def observe_error(self) -> None:
        with self._lock:
            self.total_errors += 1

    def attach_tracer(self, tracer) -> None:
        """Fold a :class:`~bert_pytorch_tpu_torch.serve.tracing.TraceCollector`
        into this rollup: ``snapshot()``/``/statsz`` gain the run-level
        ``phases`` sub-object (queue-wait share, per-phase p95s, SLO
        accounting) and ``finish()`` flushes the tracer's partial
        serve_phase windows — one scrape surface stays consistent with
        /metricsz."""
        with self._lock:
            self._tracer = tracer

    def request_count(self) -> int:
        """Completed-request total, read under the lock (the serve
        heartbeat's step counter — a bare ``total_requests`` read would
        race the dispatch thread, torchlint LK501)."""
        with self._lock:
            return self.total_requests

    def observe_cold_start(self, startup: dict) -> Optional[dict]:
        """Record the engine's startup stats (``InferenceEngine.startup``)
        and emit one ``serve_cold_start`` record: how long the AOT warmup
        took and how many of its compiles were real XLA compiles vs
        persistent-cache hits — THE restart-cost signal (a warm replica
        shows ``compiles_cold == 0``; the cache counter events behind the
        split are the authority, docs/serving.md). Fields also ride
        ``snapshot()``/``/statsz`` so a router can see each replica's
        quantize mode and startup cost."""
        if not startup:
            return None
        with self._lock:
            if self._cold_start == startup:
                # A stop()/start() cycle re-observes the SAME engine
                # start (warmup didn't run again); re-emitting would
                # double-count cold compiles in the report's summed
                # warm-restart gate. A genuine re-warmup produces a
                # fresh stats dict (new cold_start_s) and is recorded.
                return None
            self._cold_start = dict(startup)
        record = {"kind": "serve_cold_start", "tag": "serve"}
        record.update(startup)
        if self.emit is not None:
            self.emit(record)
        return record

    def reset_clock(self) -> None:
        """Restart the run/window wall-clock base. Called by the service
        after engine warmup so ``requests_per_sec`` measures serving time,
        not the AOT compile phase it would otherwise amortize in."""
        with self._lock:
            now = self._clock()
            self._t0 = now
            self._window_t0 = now

    # -- records ---------------------------------------------------------

    def _occupancy(self, real: int, budget: int) -> Optional[float]:
        if budget <= 0:
            return None
        # Clamp into the schema's (0, 1] — an all-pad window (real == 0)
        # cannot happen because every dispatched request carries >= 2
        # tokens, but guard the floor anyway.
        return round(min(1.0, max(real, 1) / budget), 4)

    @staticmethod
    def _idle_share(gap_s: float, busy_s: float) -> Optional[float]:
        """Device-idle share over the batches that carried a gap sample
        (None before a second forward exists — one batch has no gap)."""
        total = gap_s + busy_s
        if total <= 0:
            return None
        return round(min(1.0, max(0.0, gap_s / total)), 4)

    def flush_window(self) -> Optional[dict]:
        """Emit (and return) the current window record; None when empty."""
        with self._lock:
            if not self._e2e:
                return None
            now = self._clock()
            wall = max(now - self._window_t0, 1e-9)
            record = {
                "kind": "serve_window",
                "tag": "serve",
                "window_requests": len(self._e2e),
                "batches": self._batches,
                "requests_per_sec": round(len(self._e2e) / wall, 3),
                "queue_depth_max": self._depth_max,
                "compiles": self._compiles,
            }
            record.update(_latency_fields("latency", self._e2e))
            record.update(_latency_fields("device", self._device))
            occ = self._occupancy(self._real_tokens, self._budget_tokens)
            if occ is not None:
                record["batch_occupancy"] = occ
            record["admitted_late"] = self._admitted_late
            idle = self._idle_share(self._gap_s, self._gap_busy_s)
            if idle is not None:
                record["device_idle_share"] = idle
            self._e2e = []
            self._device = []
            self._batches = 0
            self._real_tokens = 0
            self._budget_tokens = 0
            self._depth_max = 0
            self._compiles = 0
            self._admitted_late = 0
            self._gap_s = 0.0
            self._gap_busy_s = 0.0
            self._window_t0 = now
        if self.emit is not None:
            self.emit(record)
        return record

    def snapshot(self, include_phases: bool = True) -> dict:
        """Run-level rollup for /statsz and the serve_summary record.
        With a tracer attached, carries its run-level phase rollup as
        the ``phases`` sub-object (same numbers /metricsz exports);
        ``include_phases=False`` skips that merge for callers that only
        want the base gauges (the /metricsz renderer — computing the
        tracer's full percentile rollup per scrape just to discard it
        would hold the tracer lock against the dispatch thread)."""
        with self._lock:
            tracer = self._tracer if include_phases else None
            wall = max(self._clock() - self._t0, 1e-9)
            record = {
                "requests": self.total_requests,
                "batches": self.total_batches,
                "errors": self.total_errors,
                "requests_per_sec": round(self.total_requests / wall, 3),
                "queue_depth_max": self._run_depth_max,
                "compiles": self._run_compiles,
            }
            record.update(_latency_fields("latency", self._run_e2e))
            record.update(_latency_fields("device", self._run_device))
            occ = self._occupancy(self._run_real_tokens,
                                  self._run_budget_tokens)
            if occ is not None:
                record["batch_occupancy"] = occ
            record["admitted_late"] = self._run_admitted_late
            idle = self._idle_share(self._run_gap_s, self._run_gap_busy_s)
            if idle is not None:
                record["device_idle_share"] = idle
            if self._cold_start is not None:
                # 'compiles' here is the STEADY-STATE count (zero after
                # warmup — the serve acceptance); the warmup compile
                # split keeps its own prefix.
                cs = self._cold_start
                record["cold_start_s"] = cs.get("cold_start_s")
                for key in ("compiles", "compiles_cold", "compiles_warm"):
                    if cs.get(key) is not None:
                        record[f"warmup_{key}"] = cs[key]
                for key in ("quantize", "attention_backend",
                            "weight_bytes", "fuse_epilogues", "autotune"):
                    if cs.get(key) is not None:
                        record[key] = cs[key]
        # Outside the lock: the tracer takes its own lock, and nesting
        # the two buys nothing (the binding was read consistently above).
        if tracer is not None:
            phases = tracer.phase_snapshot()
            if phases:
                record["phases"] = phases
        return record

    def finish(self) -> Optional[dict]:
        """Flush the partial window and emit the serve_summary record
        (and the attached tracer's partial serve_phase windows)."""
        with self._lock:
            tracer = self._tracer
        if tracer is not None:
            tracer.finish()
        self.flush_window()
        # snapshot() reads the run totals under the lock — the bare
        # total_requests read that used to sit here raced the dispatch
        # thread's observe_batch (a lock-discipline finding).
        snap = self.snapshot()
        if not snap["requests"]:
            return None
        record = {"kind": "serve_summary", "tag": "serve"}
        record.update(snap)
        if self.emit is not None:
            self.emit(record)
        return record
