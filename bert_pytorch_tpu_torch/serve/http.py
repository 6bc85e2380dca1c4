"""Stdlib JSON-over-HTTP front end for the serving engine
(docs/serving.md).

``ThreadingHTTPServer`` gives one OS thread per in-flight connection —
each worker blocks in :meth:`ServingService.submit` while the single
dispatch thread batches across all of them, which is exactly the
concurrency shape dynamic micro-batching wants. No framework, no new
dependency: the repo's hard constraint is stdlib-only for the server.

Routes:

* ``POST /v1/<task>``  — task in {fill_mask, classify, squad, ner}
  (whichever the engine was configured with); JSON body is the task
  payload (serve/tasks.py docstrings); 200 with the result JSON,
  400 on bad payloads, 404 on unknown tasks, 503 on
  timeout/overload/draining;
* ``GET  /healthz``    — DISPATCH-THREAD liveness + drain state
  (docs/fault_tolerance.md): 200 only while the thread that actually
  serves results is alive and accepting; 503 when draining for
  shutdown or when dispatch died (an HTTP thread answering proves
  nothing about the serving path) — load balancers stop routing on
  the first failed probe;
* ``GET  /statsz``     — the live ServeTelemetry rollup (requests,
  latency percentiles, batch occupancy, compile count; with tracing
  enabled, the ``phases`` sub-object carries the run-level queue-wait
  share and per-phase p95s; with a capture controller attached, the
  ``profile`` sub-object carries the live capture phase / last window);
* ``POST /profilez``   — arm an on-demand profiling capture
  (telemetry/sampler.py): the dispatch plane starts a bounded
  host-thread-sampler + ``torch.profiler`` window at the next boundary
  and emits a ``profile_window`` record when it expires. JSON body (all
  optional): ``duration_s``, ``sample_interval_s``,
  ``max_samples``, ``top_k``, ``trigger``. 200 with the armed
  parameters, 409 while a capture is already armed or active (traces
  cannot nest), 404 when the service was built without a controller;
* ``GET  /metricsz``   — Prometheus text exposition (serve/tracing.py):
  per-task request/error/over-SLO counters, per-(task, phase) latency
  histograms, queue depth / occupancy / cold-start gauges — the scrape
  surface the router and standard collectors consume. 404 when the
  service was built without a tracer;
* ``POST /swapz``      — hot-swap one task's params to a new model
  version (docs/serving.md "Model registry & canary rollouts"). JSON
  body: ``task``, ``checkpoint`` (path the replica can read),
  ``version`` (the registry version name). The load runs on this
  control thread off the dispatch path; the flip is atomic, so
  in-flight batches finish on the old version. 200 with the swap info
  (task, version, from_version, checkpoint, load_s, and the compile
  counts: 0, since the kernels were built and loaded at startup), 409
  while another swap is in flight (loads cannot overlap), 404 on an
  unknown task or an engine without ``swap_params``, 400 on a missing
  checkpoint; a failed load answers 500 and leaves the old version
  serving.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from bert_pytorch_tpu_torch.serve.batcher import BatcherFull
from bert_pytorch_tpu_torch.serve.engine import SwapBusy, SwapUnsupported
from bert_pytorch_tpu_torch.serve.service import ServiceDraining, ServingService
from bert_pytorch_tpu_torch.serve.tracing import (TRACE_HEADER,
                                            TRACE_ID_RESPONSE_HEADER,
                                            parse_trace_header)

MAX_BODY_BYTES = 1 << 20  # 1 MiB: plenty for text payloads, bounds abuse


class ServeHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # socketserver's default listen backlog is 5 — a concurrent connect
    # burst (the router fanning out, a probe storm) overflows it and the
    # kernel RSTs the excess mid-handshake, surfacing as client-side
    # ConnectionResetError before the service ever sees the request.
    request_queue_size = 128
    # The service rides on the server object so handler instances (one per
    # request) can reach it without globals.
    service: ServingService = None
    request_timeout_s: float = 30.0


def _make_handler():
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet; telemetry is the log
            pass

        def _reply(self, code: int, payload: dict,
                   headers: dict = None) -> None:
            self._reply_text(code, json.dumps(payload), "application/json",
                             headers)

        def _reply_text(self, code: int, text: str, content_type: str,
                        headers: dict = None) -> None:
            body = text.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            service = self.server.service
            if self.path == "/healthz":
                health = service.health()
                health.update({
                    "tasks": sorted(service.engine.tasks),
                    "buckets": list(service.engine.buckets),
                    "warmed": service.engine.warmed,
                })
                self._reply(200 if health["status"] == "ok" else 503,
                            health)
            elif self.path == "/statsz":
                snap = service.telemetry.snapshot()
                if service.capture is not None:
                    snap["profile"] = service.capture.status()
                swap_stats = getattr(service.engine, "swap_stats", None)
                if callable(swap_stats):
                    # serving version + swap/torn counters (the rollout
                    # controller and chaos harness scrape these).
                    snap.update(swap_stats())
                self._reply(200, snap)
            elif self.path == "/metricsz":
                text = service.metrics_text()
                if text is None:
                    self._reply(404, {
                        "error": "metrics export disabled: the service "
                                 "has no tracer (--trace_sample_rate / "
                                 "serve/tracing.py)"})
                else:
                    # The Prometheus text-exposition content type
                    # (version 0.0.4 — the format every scraper speaks).
                    self._reply_text(
                        200, text,
                        "text/plain; version=0.0.4; charset=utf-8")
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            service = self.server.service
            # Inbound router trace context (docs/observability.md "Trace
            # propagation"): adopted by the tracer so fleet-wide sampling
            # is consistent, and ECHOED on every response — sampled or
            # not — so clients correlate without relying on sampling.
            ctx = parse_trace_header(self.headers.get(TRACE_HEADER))
            echo = ({TRACE_ID_RESPONSE_HEADER: ctx["trace_id"]}
                    if ctx else None)
            if self.path.rstrip("/") == "/profilez":
                self._profilez(service, echo)
                return
            if self.path.rstrip("/") == "/swapz":
                self._swapz(service, echo)
                return
            if not self.path.startswith("/v1/"):
                self._reply(404, {"error": f"no route {self.path}"}, echo)
                return
            task = self.path[len("/v1/"):].strip("/")
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_BODY_BYTES:
                    self._reply(413, {"error": "payload too large"}, echo)
                    return
                payload = json.loads(
                    self.rfile.read(length).decode("utf-8") or "{}")
                if not isinstance(payload, dict):
                    raise ValueError("payload must be a JSON object")
            except ValueError as exc:
                self._reply(400, {"error": f"bad JSON payload: {exc}"},
                            echo)
                return
            try:
                result = service.submit(
                    task, payload, timeout=self.server.request_timeout_s,
                    trace_ctx=ctx)
            except ValueError as exc:
                code = 404 if "unknown task" in str(exc) else 400
                self._reply(code, {"error": str(exc)}, echo)
            except KeyError as exc:
                self._reply(400, {"error": f"missing payload field {exc}"},
                            echo)
            except (TimeoutError, BatcherFull, ServiceDraining) as exc:
                self._reply(503, {"error": str(exc)}, echo)
            except Exception as exc:
                self._reply(500, {"error": f"{type(exc).__name__}: {exc}"},
                            echo)
            else:
                self._reply(200, result, echo)

        def _swapz(self, service, echo) -> None:
            """Hot-swap control endpoint. The checkpoint load runs on
            THIS thread (one per request — the dispatch plane never
            blocks on it); 409 while another swap is in flight, the
            same no-overlap discipline as /profilez."""
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_BODY_BYTES:
                    self._reply(413, {"error": "payload too large"}, echo)
                    return
                body = json.loads(
                    self.rfile.read(length).decode("utf-8") or "{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
                missing = [k for k in ("task", "checkpoint", "version")
                           if not body.get(k)]
                if missing:
                    raise ValueError(f"missing fields {missing}")
            except ValueError as exc:
                self._reply(400, {"error": f"bad swap request: {exc}"},
                            echo)
                return
            try:
                info = service.swap(str(body["task"]),
                                    str(body["checkpoint"]),
                                    str(body["version"]))
            except SwapBusy as exc:
                self._reply(409, {"error": str(exc)}, echo)
            except SwapUnsupported as exc:
                self._reply(404, {"error": str(exc)}, echo)
            except ValueError as exc:
                code = 404 if "unknown task" in str(exc) else 400
                self._reply(code, {"error": str(exc)}, echo)
            except FileNotFoundError as exc:
                self._reply(400, {"error": str(exc)}, echo)
            except Exception as exc:
                self._reply(500, {"error": f"{type(exc).__name__}: {exc}"},
                            echo)
            else:
                self._reply(200, dict(info, ok=True), echo)

        def _profilez(self, service, echo) -> None:
            """Arm an on-demand capture. 409 — not a second start — when
            one is already armed/active: profiler traces cannot nest,
            and the controller's refusal is what keeps two POSTs from
            stacking two profiler starts."""
            if service.capture is None:
                self._reply(404, {
                    "error": "profiling disabled: the service has no "
                             "capture controller"}, echo)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_BODY_BYTES:
                    self._reply(413, {"error": "payload too large"}, echo)
                    return
                body = json.loads(
                    self.rfile.read(length).decode("utf-8") or "{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except ValueError as exc:
                self._reply(400, {"error": f"bad JSON payload: {exc}"},
                            echo)
                return
            kwargs = {k: body[k] for k in (
                "duration_s", "sample_interval_s", "max_samples",
                "top_k", "trigger") if k in body}
            ok, payload = service.capture.arm(**kwargs)
            # Busy (the payload names the blocking phase) is 409; a
            # refused parameter is the caller's fault, 400.
            code = 200 if ok else (409 if "phase" in payload else 400)
            self._reply(code, payload, echo)

    return Handler


def make_server(service: ServingService, host: str = "127.0.0.1",
                port: int = 8000,
                request_timeout_s: float = 30.0) -> ServeHTTPServer:
    """Build (but do not start) the HTTP server; ``port=0`` binds an
    ephemeral port (tests read ``server.server_address``)."""
    server = ServeHTTPServer((host, port), _make_handler())
    server.service = service
    server.request_timeout_s = request_timeout_s
    return server
