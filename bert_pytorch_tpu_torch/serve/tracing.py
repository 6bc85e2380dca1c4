"""Request-level tracing and the metrics export plane for the serving
tier (docs/serving.md "Request tracing & metrics").

The serving path's coarse window stats (serve/stats.py) say how slow a
replica is; they cannot say WHERE a request's time went — a router doing
admission control, or an engineer attributing a tail-latency incident,
needs the request's life decomposed. This module owns that
decomposition, in the Dapper mold (Sigelman et al. 2010, PAPERS.md):

* **span taxonomy** — every completed request is decomposed into four
  disjoint phases measured by the dispatch path (serve/service.py):

  ========== ==========================================================
  ``queue``        submit/enqueue until the batcher pops the request
                   (includes any plan-leftover requeue round trips)
  ``assembly``     pop until device dispatch: batch planning, bucket
                   choice, packing/padding the fixed-shape arrays, plus
                   the batch's demux host conversion
  ``execute``      the jitted forward including the device sync (shared
                   by every request in the batch)
  ``postprocess``  the request's OWN task-handler decode
  ========== ==========================================================

  The phases are sub-intervals of the request's end-to-end latency, so
  ``sum(phase durations) <= total`` and ``queue <= total`` hold by
  construction — schema-lintable invariants (telemetry/schema.py), not
  hopes. Host-side ``prepare`` time (tokenization on the HTTP worker,
  serve/tasks.py) happens BEFORE the request is enqueued, so it rides
  the trace record as ``prepare_ms`` context rather than a span.

* **head sampling + always-sample-slow** — ``sample_rate`` picks the
  head-sampled fraction deterministically from the request id (a Knuth
  multiplicative hash, so reruns of a trace replay sample the same
  requests); any request whose total exceeds the SLO target is traced
  REGARDLESS of the rate ("The Tail at Scale", Dean & Barroso 2013: the
  slow requests are precisely the ones worth explaining), bounded by a
  per-(task, window) budget of :data:`SLOW_TRACE_WINDOW_CAP` forced
  exports so an everything-is-slow incident cannot make trace volume
  proportional to load (the over-SLO counters are never capped).
  Emitted records carry ``sampled`` (was it head-sampled) and
  ``sample_reason`` (``slow`` whenever the request was over the SLO —
  even if it was also head-sampled — else ``head``).

* **schema-v1 export** — sampled requests emit ``kind="serve_trace"``
  records (span tree + bucket/packing context); every ``window``
  completed requests per task emit one ``kind="serve_phase"``
  latency-decomposition aggregate (per-phase p50/p95, total p50/p95/p99,
  ``queue_wait_share``, over-SLO count). Both flow through the same
  JSONL sink as the rest of telemetry and are summarized/gated by
  ``telemetry-report`` ("serve queue-wait share", "serve SLO p99").

* **/metricsz** — :meth:`TraceCollector.metrics_text` renders the
  per-task counters and phase-latency histograms in Prometheus text
  exposition format so the future router and standard scrapers consume
  one surface; serve/http.py serves it, with the service-level gauges
  (queue depth, occupancy, cold start) appended by
  ``ServingService.metrics_text``.

Thread-safety: ``observe``/``flush``/``finish`` run on the single
dispatch thread while ``observe_error`` (HTTP workers) and
``metrics_text``/``phase_snapshot`` (/metricsz and /statsz scrapes) run
on HTTP worker threads — all shared state lives in the per-task stats
map behind one lock (declared in the port's concurrency registry,
analysis/concurrency.py, enforced by torchlint LK501).
"""

from __future__ import annotations

import collections
import threading
import uuid
from typing import Callable, Dict, List, Optional

# Nearest-rank percentile: ONE implementation for the whole serve
# telemetry surface (serve_window and serve_phase records must agree on
# the rank convention).
from bert_pytorch_tpu_torch.serve.stats import _pctl

PHASES = ("queue", "assembly", "execute", "postprocess")

# Histogram bucket upper bounds (milliseconds) for the /metricsz
# phase-latency histograms. Fixed and shared across tasks/phases so
# scrapes aggregate; +Inf is implicit (the _count series).
HIST_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                   500.0, 1000.0, 2500.0)

# Run-level percentile basis per (task, phase): most recent this-many
# samples — the bounded-memory rationale of serve/stats.py
# RUN_SAMPLE_CAP, deliberately smaller here because the tracer keeps
# one series per (task, phase + total), ~5x as many as the stats rollup.
RUN_SAMPLE_CAP = 4096

# At most this many slow-FORCED serve_trace emissions per (task,
# serve_phase window): during an incident where most traffic breaches
# the SLO, the always-sample-slow rule would otherwise make trace
# output proportional to load exactly when the replica is drowning —
# and each emit is dispatch-thread disk I/O. The over-SLO COUNTERS
# (/metricsz, serve_phase windows, the report verdict) stay exact;
# only the per-request span-tree exports are budgeted (Dapper-style).
# Head-sampled traces never draw on this budget.
SLOW_TRACE_WINDOW_CAP = 16


def _sample_hash(request_id: int) -> float:
    """Deterministic [0, 1) hash of a request id (Knuth multiplicative):
    head sampling must not depend on interleaving or a shared RNG, so a
    replayed trace samples the SAME requests every run."""
    return ((int(request_id) * 2654435761) & 0xFFFFFFFF) / float(1 << 32)


# -- cross-tier trace-context propagation (Dapper-style) ---------------
# The router mints one fleet-unique trace id + sampling decision per
# client request and forwards them on every dispatch attempt:
#
#     X-Bert-Trace: <trace_id>;attempt=<n>;sampled=<0|1>
#
# and every HTTP response (replica and router relay alike) echoes
#
#     X-Bert-Trace-Id: <trace_id>
#
# so clients and the chaos harness can correlate WITHOUT relying on
# sampling. serve/router.py keeps its own copy of the wire format (it
# loads by file path, jax-free, and must not import this module); the
# round-trip is pinned by tests/test_fleet_tracing.py.
TRACE_HEADER = "X-Bert-Trace"
TRACE_ID_RESPONSE_HEADER = "X-Bert-Trace-Id"


def parse_trace_header(value) -> Optional[dict]:
    """Decode an inbound ``X-Bert-Trace`` header into a trace context
    ``{"trace_id", "attempt", "sampled"}``; None on anything malformed
    (a bad header must never fail the request — tracing is best-effort
    observability, not admission control)."""
    if not isinstance(value, str) or not value.strip():
        return None
    parts = [p.strip() for p in value.split(";")]
    trace_id = parts[0]
    if not trace_id:
        return None
    ctx = {"trace_id": trace_id, "attempt": 1, "sampled": False}
    for part in parts[1:]:
        key, sep, raw = part.partition("=")
        if not sep:
            return None
        if key == "attempt":
            try:
                attempt = int(raw)
            except ValueError:
                return None
            if attempt < 1:
                return None
            ctx["attempt"] = attempt
        elif key == "sampled":
            if raw not in ("0", "1"):
                return None
            ctx["sampled"] = raw == "1"
        # Unknown keys are forward-compatible: ignored, not fatal.
    return ctx


def format_trace_header(trace_id: str, attempt: int,
                        sampled: bool) -> str:
    """Encode a trace context for the ``X-Bert-Trace`` request header
    (the inverse of :func:`parse_trace_header`)."""
    return f"{trace_id};attempt={int(attempt)};sampled={1 if sampled else 0}"


class _TaskStats:
    """Per-task aggregates: run counters, /metricsz histograms, and the
    current serve_phase window. Only ever touched under the collector's
    lock."""

    def __init__(self):
        self.requests = 0
        self.errors = 0
        self.sampled = 0
        self.over_slo = 0
        # Requests that joined a forming batch through the admission
        # window (continuous batching, docs/serving.md) — the
        # bert_serve_admitted_late_total counter.
        self.admitted_late = 0
        # Prometheus histogram state per phase (+ "total"): non-cumulative
        # per-bucket counts, rendered cumulative at scrape time.
        self.hist = {p: [0] * (len(HIST_BUCKETS_MS) + 1)
                     for p in PHASES + ("total",)}
        self.hist_sum = {p: 0.0 for p in PHASES + ("total",)}
        # Run-level percentile samples (bounded).
        self.run_samples = {p: collections.deque(maxlen=RUN_SAMPLE_CAP)
                            for p in PHASES + ("total",)}
        self.run_phase_s = {p: 0.0 for p in PHASES}
        self.run_total_s = 0.0
        self.reset_window()

    def reset_window(self):
        self.win_samples = {p: [] for p in PHASES + ("total",)}
        self.win_phase_s = {p: 0.0 for p in PHASES}
        self.win_total_s = 0.0
        self.win_over_slo = 0
        self.win_sampled = 0
        self.win_slow_forced = 0
        self.win_admitted_late = 0

    def note(self, phases_s: Dict[str, float], total_s: float) -> None:
        self.requests += 1
        for name, dur in list(phases_s.items()) + [("total", total_s)]:
            ms = dur * 1000.0
            idx = len(HIST_BUCKETS_MS)
            for i, bound in enumerate(HIST_BUCKETS_MS):
                if ms <= bound:
                    idx = i
                    break
            self.hist[name][idx] += 1
            self.hist_sum[name] += ms
            self.run_samples[name].append(ms)
            self.win_samples[name].append(ms)
        for name, dur in phases_s.items():
            self.run_phase_s[name] += dur
            self.win_phase_s[name] += dur
        self.run_total_s += total_s
        self.win_total_s += total_s


class TraceCollector:
    """Collects per-request phase decompositions; emits ``serve_trace``
    and ``serve_phase`` records and renders the /metricsz export.

    ``slo_p99_ms`` is the per-request latency target the SLO machinery
    and the always-sample-slow rule key on (None/0 disables both);
    ``error_budget`` is the fraction of requests allowed over the target
    before the error budget is burned (telemetry-report turns the pair
    into the rolling-window SLO verdict).
    """

    def __init__(self, emit: Optional[Callable[[dict], None]] = None,
                 sample_rate: float = 0.0,
                 slo_p99_ms: Optional[float] = None,
                 error_budget: float = 0.01,
                 window: int = 64):
        if not 0.0 <= float(sample_rate) <= 1.0:
            raise ValueError(
                f"sample_rate must be in [0, 1], got {sample_rate}")
        self.emit = emit
        self.sample_rate = float(sample_rate)
        self.slo_p99_ms = (float(slo_p99_ms)
                           if slo_p99_ms else None)  # 0/None = disabled
        self.error_budget = float(error_budget)
        self.window = max(1, int(window))
        # One run-scoped token namespaces trace ids across restarts (the
        # request-id counter alone restarts at 0 with the process).
        self._run_token = uuid.uuid4().hex[:8]
        self._lock = threading.Lock()
        # task -> _TaskStats; the ONLY shared mutable state (registered
        # in the concurrency registry): written by the dispatch thread
        # (observe) and HTTP workers (observe_error), read by /metricsz
        # and /statsz scrape threads.
        self._tasks: Dict[str, _TaskStats] = {}

    # -- producer side (dispatch thread) --------------------------------

    def observe(self, task: str, request_id: int,
                phases_s: Dict[str, float], total_s: float,
                bucket: Optional[int] = None, packed: Optional[bool] = None,
                batch_requests: Optional[int] = None,
                occupancy: Optional[float] = None,
                prepare_s: Optional[float] = None,
                pack_s: Optional[float] = None,
                admitted_late: Optional[bool] = None,
                staged_wait_s: Optional[float] = None,
                trace_ctx: Optional[dict] = None) -> Optional[dict]:
        """Record one completed request's phase decomposition; returns
        the emitted ``serve_trace`` record when the request was sampled
        (head rate, or forced by the over-SLO slow rule), else None.
        ``phases_s`` maps each name in :data:`PHASES` to its duration in
        seconds. ``admitted_late`` marks a request that joined a forming
        batch through the pipelined plane's admission window;
        ``staged_wait_s`` is its batch's staging-complete -> executor
        pickup delay (pipeline buffering — context, not a span).
        ``trace_ctx`` is the inbound router context
        (:func:`parse_trace_header`): when present, the ROUTER'S
        sampling decision replaces the local head hash — both ways, so
        sampling is consistent fleet-wide — while the always-sample-slow
        rule still fires locally, and the emitted record chains to the
        router's span tree via ``parent_trace_id``/``attempt``."""
        phases_s = {name: max(0.0, float(phases_s.get(name, 0.0)))
                    for name in PHASES}
        total_s = max(float(total_s), sum(phases_s.values()))
        total_ms = total_s * 1000.0
        over_slo = bool(self.slo_p99_ms and total_ms > self.slo_p99_ms)
        if trace_ctx is not None and trace_ctx.get("trace_id"):
            head = bool(trace_ctx.get("sampled"))
        else:
            trace_ctx = None
            head = (self.sample_rate > 0.0
                    and _sample_hash(request_id) < self.sample_rate)
        phase_record = None
        emit_trace = False
        with self._lock:
            stats = self._tasks.setdefault(task, _TaskStats())
            stats.note(phases_s, total_s)
            if admitted_late:
                stats.admitted_late += 1
                stats.win_admitted_late += 1
            if over_slo:
                stats.over_slo += 1
                stats.win_over_slo += 1
            if self.emit is not None:
                if head:
                    emit_trace = True
                elif (over_slo
                      and stats.win_slow_forced < SLOW_TRACE_WINDOW_CAP):
                    # Slow-forced export draws on the per-window budget
                    # (SLOW_TRACE_WINDOW_CAP); the over-SLO counters
                    # above are never capped.
                    stats.win_slow_forced += 1
                    emit_trace = True
            if emit_trace:
                stats.sampled += 1
                stats.win_sampled += 1
            if len(stats.win_samples["total"]) >= self.window:
                # Build the record only when a sink will take it; the
                # reset stays unconditional so win_samples stays bounded
                # and the slow-forced budget is per-window either way.
                if self.emit is not None:
                    phase_record = self._window_record_locked(task, stats)
                stats.reset_window()
        trace_record = None
        if emit_trace:
            trace_record = self._trace_record(
                task, request_id, phases_s, total_ms, sampled=head,
                over_slo=over_slo,
                bucket=bucket, packed=packed, batch_requests=batch_requests,
                occupancy=occupancy, prepare_s=prepare_s, pack_s=pack_s,
                admitted_late=admitted_late, staged_wait_s=staged_wait_s,
                trace_ctx=trace_ctx)
            self.emit(trace_record)
        if phase_record is not None:
            self.emit(phase_record)
        return trace_record

    def observe_error(self, task: str) -> None:
        """Count one failed request for /metricsz (called from HTTP
        worker threads on timeout/postprocess/execute errors)."""
        with self._lock:
            self._tasks.setdefault(task, _TaskStats()).errors += 1

    def _trace_record(self, task, request_id, phases_s, total_ms, sampled,
                      over_slo, bucket, packed, batch_requests, occupancy,
                      prepare_s, pack_s=None, admitted_late=None,
                      staged_wait_s=None, trace_ctx=None) -> dict:
        spans = []
        start = 0.0
        for name in PHASES:
            dur = phases_s[name] * 1000.0
            spans.append({"name": name,
                          "start_ms": round(start, 3),
                          "dur_ms": round(dur, 3)})
            start += dur
        record = {
            "kind": "serve_trace",
            "tag": "serve",
            "trace_id": f"{self._run_token}-{int(request_id):x}",
            "task": task,
            # Round the total UP at the same precision so the lint's
            # "sum of span durations <= total_ms" survives rounding.
            "total_ms": round(max(total_ms, start), 3),
            "queue_wait_ms": round(phases_s["queue"] * 1000.0, 3),
            "sampled": bool(sampled),
            # "slow" takes priority: the report's tail-attribution count
            # (serve_traces_slow) keys on it, and an over-SLO request
            # that also happened to be head-sampled is still an over-SLO
            # request. `sampled` alone records head-sampledness.
            "sample_reason": "slow" if over_slo else "head",
            "spans": spans,
        }
        if trace_ctx is not None:
            # Chain to the router's span tree (the fleet collector's
            # stitch join key). `attempt` is the router's 1-based
            # dispatch attempt that reached this replica — a failed-over
            # request's surviving serve_trace carries attempt 2+.
            record["parent_trace_id"] = trace_ctx["trace_id"]
            record["attempt"] = int(trace_ctx.get("attempt", 1))
        if self.slo_p99_ms:
            record["slo_target_ms"] = self.slo_p99_ms
        if bucket is not None:
            record["bucket"] = int(bucket)
        if packed is not None:
            record["packed"] = bool(packed)
        if batch_requests is not None:
            record["batch_requests"] = int(batch_requests)
        if occupancy is not None:
            record["occupancy"] = round(float(occupancy), 4)
        if prepare_s is not None:
            record["prepare_ms"] = round(float(prepare_s) * 1000.0, 3)
        if pack_s is not None:
            # The engine's array-fill share of the assembly span
            # (serve/engine.py execute info["pack_s"]) — sub-attribution
            # context, already counted inside the assembly duration.
            record["pack_ms"] = round(float(pack_s) * 1000.0, 3)
        if admitted_late is not None:
            # Continuous batching: did this request join a FORMING batch
            # through the admission window (pipelined dispatch) instead
            # of waiting for its own flush? Schema-linted as a real
            # boolean — the A/B acceptance counts on it.
            record["admitted_late"] = bool(admitted_late)
        if staged_wait_s is not None:
            # Pipeline buffering between staging and the executor's
            # pickup — context like pack_ms, NOT a span: it is waiting,
            # not work, and sits in the slack between sum(spans) and
            # total_ms.
            record["staged_wait_ms"] = round(
                float(staged_wait_s) * 1000.0, 3)
        return record

    def _window_record_locked(self, task: str, stats: _TaskStats) -> dict:
        """Build one serve_phase record from the task's current window
        (caller holds the lock and resets the window after)."""
        record = {
            "kind": "serve_phase",
            "tag": "serve",
            "task": task,
            "window_requests": len(stats.win_samples["total"]),
            "sampled_traces": stats.win_sampled,
            "admitted_late": stats.win_admitted_late,
        }
        for name in PHASES:
            s = sorted(stats.win_samples[name])
            record[f"{name}_p50_ms"] = round(_pctl(s, 0.50), 3)
            record[f"{name}_p95_ms"] = round(_pctl(s, 0.95), 3)
        s = sorted(stats.win_samples["total"])
        record["total_p50_ms"] = round(_pctl(s, 0.50), 3)
        record["total_p95_ms"] = round(_pctl(s, 0.95), 3)
        record["total_p99_ms"] = round(_pctl(s, 0.99), 3)
        share = (stats.win_phase_s["queue"] / stats.win_total_s
                 if stats.win_total_s > 0 else 0.0)
        record["queue_wait_share"] = round(min(1.0, share), 4)
        if self.slo_p99_ms:
            record["slo_target_ms"] = self.slo_p99_ms
            record["slo_budget"] = self.error_budget
            record["over_slo"] = stats.win_over_slo
        return record

    def finish(self) -> None:
        """Flush every task's partial serve_phase window (end of run /
        service stop)."""
        if self.emit is None:
            return
        flushed = []
        with self._lock:
            for task, stats in self._tasks.items():
                if stats.win_samples["total"]:
                    flushed.append(self._window_record_locked(task, stats))
                    stats.reset_window()
        for record in flushed:
            self.emit(record)

    # -- consumer side (scrape threads) ----------------------------------

    def phase_snapshot(self) -> Optional[dict]:
        """Run-level phase rollup for /statsz and the bench result JSON:
        request-weighted queue-wait share, per-phase p95s, SLO
        accounting. None before the first completed request.

        The lock only covers copying the aggregates out — sorting the
        sample history happens after release, so a /statsz scrape never
        stalls the dispatch thread's ``observe`` for the sort."""
        with self._lock:
            if not self._tasks:
                return None
            requests = sum(s.requests for s in self._tasks.values())
            if not requests:
                return None
            out = {
                "requests": requests,
                "errors": sum(s.errors for s in self._tasks.values()),
                "sampled_traces": sum(
                    s.sampled for s in self._tasks.values()),
                "admitted_late": sum(
                    s.admitted_late for s in self._tasks.values()),
            }
            total_s = sum(s.run_total_s for s in self._tasks.values())
            queue_s = sum(s.run_phase_s["queue"]
                          for s in self._tasks.values())
            merged = {name: [v for s in self._tasks.values()
                             for v in s.run_samples[name]]
                      for name in PHASES}
            over = sum(s.over_slo for s in self._tasks.values())
        if total_s > 0:
            out["queue_wait_share"] = round(min(1.0, queue_s / total_s), 4)
        for name in PHASES:
            if merged[name]:
                out[f"{name}_p95_ms"] = round(
                    _pctl(sorted(merged[name]), 0.95), 3)
        if self.slo_p99_ms:
            out["slo_target_ms"] = self.slo_p99_ms
            out["over_slo"] = over
            budget = self.error_budget * requests
            out["slo_budget_burn"] = round(
                over / budget, 4) if budget > 0 else None
        return out

    def metrics_text(self, prefix: str = "bert_serve") -> str:
        """Prometheus text-exposition rendering of the per-task request/
        error/over-SLO counters, sampled-trace counters, and per-(task,
        phase) latency histograms. Service-level gauges (queue depth,
        occupancy, cold start) are appended by
        ``ServingService.metrics_text`` (serve/service.py).

        The lock only covers copying the counters and histogram arrays
        out — the exposition text is formatted after release (same
        discipline as ``phase_snapshot``), so a scrape never stalls the
        dispatch thread's ``observe`` for the render."""
        with self._lock:
            copied = {
                task: {
                    "requests": stats.requests,
                    "errors": stats.errors,
                    "sampled": stats.sampled,
                    "over_slo": stats.over_slo,
                    "admitted_late": stats.admitted_late,
                    "hist": {p: list(stats.hist[p])
                             for p in PHASES + ("total",)},
                    "hist_sum": dict(stats.hist_sum),
                }
                for task, stats in sorted(self._tasks.items())}
        lines: List[str] = []

        def header(name, kind, help_text):
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")

        header(f"{prefix}_requests_total", "counter",
               "Completed requests per task head.")
        for task, stats in copied.items():
            lines.append(f'{prefix}_requests_total{{task="{task}"}} '
                         f"{stats['requests']}")
        header(f"{prefix}_errors_total", "counter",
               "Failed requests per task head (timeouts, execute/"
               "postprocess errors).")
        for task, stats in copied.items():
            lines.append(f'{prefix}_errors_total{{task="{task}"}} '
                         f"{stats['errors']}")
        header(f"{prefix}_traces_sampled_total", "counter",
               "Requests exported as serve_trace records.")
        for task, stats in copied.items():
            lines.append(
                f'{prefix}_traces_sampled_total{{task="{task}"}} '
                f"{stats['sampled']}")
        header(f"{prefix}_admitted_late_total", "counter",
               "Requests admitted into a forming batch through the "
               "admission window (continuous batching).")
        for task, stats in copied.items():
            lines.append(
                f'{prefix}_admitted_late_total{{task="{task}"}} '
                f"{stats['admitted_late']}")
        if self.slo_p99_ms:
            header(f"{prefix}_over_slo_total", "counter",
                   "Requests over the p99 SLO target per task head.")
            for task, stats in copied.items():
                lines.append(
                    f'{prefix}_over_slo_total{{task="{task}"}} '
                    f"{stats['over_slo']}")
            header(f"{prefix}_slo_p99_target_ms", "gauge",
                   "Per-request latency SLO target (ms).")
            lines.append(
                f"{prefix}_slo_p99_target_ms {self.slo_p99_ms:g}")
        name = f"{prefix}_phase_latency_ms"
        header(name, "histogram",
               "Per-phase request latency (ms) per task head; phases: "
               + ",".join(PHASES) + ",total.")
        for task, stats in copied.items():
            for phase in PHASES + ("total",):
                acc = 0
                labels = f'task="{task}",phase="{phase}"'
                for bound, count in zip(HIST_BUCKETS_MS,
                                        stats["hist"][phase]):
                    acc += count
                    lines.append(
                        f'{name}_bucket{{{labels},le="{bound:g}"}} '
                        f"{acc}")
                acc += stats["hist"][phase][-1]
                lines.append(
                    f'{name}_bucket{{{labels},le="+Inf"}} {acc}')
                lines.append(f"{name}_sum{{{labels}}} "
                             f"{stats['hist_sum'][phase]:.3f}")
                lines.append(f"{name}_count{{{labels}}} {acc}")
        return "\n".join(lines) + "\n"
