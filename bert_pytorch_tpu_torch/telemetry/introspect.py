"""Live training introspection: the debug endpoint every runner of the
port can open with ``--debug_port`` — a copy of the JAX package's
``telemetry/introspect.py``, route for route.

The serving replica has a live scrape surface
(``/healthz``/``/statsz``/``/metricsz``). This module gives TRAINING
processes the same three routes, from the same stdlib
``ThreadingHTTPServer`` recipe, so one collector can scrape trainers and
replicas with one format:

* ``GET /healthz``  — heartbeat-backed step liveness: 200 while a step
  completed within ``stale_after_s`` (or the run is still warming
  toward its first step), 503 once the step counter goes stale;
* ``GET /statsz``   — JSON snapshot: the last emitted ``step_window``
  record verbatim (loader gauges ride inside it), the last grad-health
  envelope, compile counters split by cache outcome, and the
  sentinel/divergence/fault tallies;
* ``GET /metricsz`` — the same numbers in Prometheus text exposition
  (version 0.0.4), ``bert_train_*``-prefixed. Every numeric field of
  the last step_window record is exported as
  ``bert_train_window_<field>`` VERBATIM (rendered with ``repr`` so the
  float round-trips): the scrape agrees with the JSONL artifact per
  metric name;
* ``POST /profilez`` — arm a bounded on-demand capture at the next step
  boundary (telemetry/sampler.py): 200 with the armed parameters, 409
  while a capture is already armed or active (profiler traces cannot
  nest), 400 on a refused parameter, 404 when the runner attached no
  capture controller.

The :class:`IntrospectionHub` is the shared state: ``TrainTelemetry``
tees every emitted record into :meth:`observe_record` and notes step
completions via :meth:`note_step`; HTTP worker threads read snapshots.
One lock guards the single state dict — the hub never calls back into
telemetry or torch, so a slow scrape can never stall the train loop for
more than the lock's copy window.

Deliberately stdlib-only: the debug server costs nothing when
``--debug_port`` is 0 (the default) and never pulls the device runtime
into an HTTP thread.
"""

from __future__ import annotations

import http.server
import json
import math
import threading
import time
from typing import Callable, Dict, Optional, Tuple

# Record kinds folded into the hub's live counters; anything else only
# bumps the record tally.
_COUNTER_KINDS = ("sentinel", "divergence", "fault")


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


class IntrospectionHub:
    """Lock-guarded live snapshot of one training process's telemetry.

    ``process`` labels the exports (``bert_train_up{process="glue"}``)
    so a fleet timeline can attribute trainer samples; ``stale_after_s``
    is the /healthz liveness bound — size it well above the worst
    healthy step time (the hung-step watchdog's advice applies: a false
    503 only flips a probe, never kills anything).
    """

    def __init__(self, process: str = "train",
                 stale_after_s: float = 60.0,
                 clock: Callable[[], float] = time.time):
        self.process = str(process)
        self.stale_after_s = float(stale_after_s)
        self._clock = clock
        # On-demand capture controller (telemetry/sampler.py), attached
        # once by TrainTelemetry before the debug server starts; None
        # keeps /profilez answering 404. Frozen binding: the controller
        # locks itself.
        self.capture = None
        self._lock = threading.Lock()
        # The ONE shared mutable slot: written by the train loop
        # (note_step) and background emitters (the
        # watchdog's fault records arrive via the emit tee), read by
        # HTTP worker threads rendering /healthz //statsz //metricsz.
        self._state: dict = {
            "started_at": clock(),
            "step": None,
            "last_step_at": None,
            "steps": 0,
            "last_loss": None,
            "records": 0,
            "last_window": None,
            "last_grad_health": None,
            "last_memory": None,
            "compiles": 0,
            "compile_s": 0.0,
            "compile_cache": {},
            "nonfinite_steps": 0,
            "divergence_warnings": 0,
            "faults": 0,
        }

    # -- producer side (train loop + background emitters) ----------------

    def note_step(self, step: int, loss=None) -> None:
        """One completed step: the /healthz liveness signal (every step,
        synced or not — liveness must not depend on the sync cadence)."""
        now = self._clock()
        with self._lock:
            self._state["step"] = int(step)
            self._state["last_step_at"] = now
            self._state["steps"] += 1
            if loss is not None:
                self._state["last_loss"] = float(loss)

    def observe_record(self, rec: dict) -> None:
        """Fold one emitted telemetry record into the live snapshot
        (called from the TrainTelemetry.emit tee, any emitting thread)."""
        if not isinstance(rec, dict):
            return
        kind = rec.get("kind")
        with self._lock:
            self._state["records"] += 1
            if kind == "step_window":
                self._state["last_window"] = dict(rec)
            elif kind == "grad_health":
                self._state["last_grad_health"] = dict(rec)
            elif kind == "memory":
                self._state["last_memory"] = dict(rec)
            elif kind == "compile":
                self._state["compiles"] += 1
                self._state["compile_s"] += float(rec.get("compile_s", 0.0)
                                                  or 0.0)
                cache = str(rec.get("cache", "?"))
                by = self._state["compile_cache"]
                by[cache] = by.get(cache, 0) + 1
            elif kind == "sentinel":
                self._state["nonfinite_steps"] += 1
            elif kind == "divergence":
                self._state["divergence_warnings"] += 1
            elif kind == "fault":
                self._state["faults"] += 1

    # -- consumer side (HTTP worker threads) -----------------------------

    def healthz(self) -> Tuple[int, dict]:
        """(http_status, body): 200 while warming or stepping within
        ``stale_after_s``; 503 once the step counter has gone stale."""
        now = self._clock()
        with self._lock:
            step = self._state["step"]
            last = self._state["last_step_at"]
            started = self._state["started_at"]
            loss = self._state["last_loss"]
        if last is None:
            status, code = "warming", 200
            age = now - started
        else:
            age = now - last
            stale = age > self.stale_after_s
            status, code = ("stale", 503) if stale else ("ok", 200)
        return code, {
            "status": status,
            "process": self.process,
            "step": step,
            "step_age_s": round(age, 3),
            "stale_after_s": self.stale_after_s,
            "uptime_s": round(now - started, 3),
            "last_loss": loss,
        }

    def statsz(self) -> dict:
        """The full live snapshot as JSON-able state."""
        now = self._clock()
        with self._lock:
            state = dict(self._state)
            state["compile_cache"] = dict(state["compile_cache"])
        state["process"] = self.process
        state["uptime_s"] = round(now - state.pop("started_at"), 3)
        if state["last_step_at"] is not None:
            state["step_age_s"] = round(now - state["last_step_at"], 3)
        state.pop("last_step_at", None)
        if self.capture is not None:
            # Capture status rides the same surface operators already
            # watch: armed/active phase, completed-capture count, and
            # the last window's headline.
            state["profile"] = self.capture.status()
        return state

    def metrics_text(self, prefix: str = "bert_train") -> str:
        """Prometheus text exposition of the live snapshot.

        The last step_window record's numeric fields are exported
        verbatim as ``<prefix>_window_<field>`` (repr-rendered so floats
        round-trip) — the per-metric-name agreement with the JSONL
        artifact. Nested gauge sub-objects (``loader``, ``prefetch``)
        flatten to
        ``<prefix>_loader_<field>`` / ``<prefix>_prefetch_<field>``.
        """
        now = self._clock()
        with self._lock:
            state = dict(self._state)
            window = dict(state["last_window"] or {})
            health = dict(state["last_grad_health"] or {})
            by_cache = dict(state["compile_cache"])
        label = f'process="{self.process}"'
        lines = []

        def metric(name, value, kind="gauge", help_text="", labels=label):
            if value is None:
                return
            if help_text:
                lines.append(f"# HELP {prefix}_{name} {help_text}")
            lines.append(f"# TYPE {prefix}_{name} {kind}")
            lines.append(f"{prefix}_{name}{{{labels}}} "
                         f"{_render(value)}")

        metric("up", 1, help_text="1 while the training process serves "
                                  "this debug endpoint.")
        metric("stale_after_seconds", self.stale_after_s,
               help_text="The /healthz step-staleness bound; scrapers "
                         "compare step_age_seconds against it.")
        metric("uptime_seconds", round(now - state["started_at"], 3))
        metric("step", state["step"],
               help_text="Last completed training step.")
        if state["last_step_at"] is not None:
            metric("step_age_seconds",
                   round(now - state["last_step_at"], 3),
                   help_text="Seconds since the last completed step "
                             "(the /healthz liveness signal).")
        metric("steps_total", state["steps"], kind="counter")
        metric("last_loss", state["last_loss"])
        metric("records_total", state["records"], kind="counter",
               help_text="Telemetry records emitted so far.")
        lines.append(f"# TYPE {prefix}_compiles_total counter")
        for cache in sorted(by_cache):
            lines.append(
                f'{prefix}_compiles_total{{{label},cache="{cache}"}} '
                f"{by_cache[cache]}")
        metric("compile_seconds_total", round(state["compile_s"], 6),
               kind="counter")
        metric("nonfinite_steps_total", state["nonfinite_steps"],
               kind="counter")
        metric("divergence_warnings_total", state["divergence_warnings"],
               kind="counter")
        metric("faults_total", state["faults"], kind="counter")
        # The last window, field for field (the JSONL-agreement export).
        for key, value in sorted(window.items()):
            if key in ("kind", "tag", "schema", "ts"):
                continue
            if _num(value):
                metric(f"window_{key}", value)
            elif isinstance(value, dict):
                for sub, sv in sorted(value.items()):
                    if _num(sv):
                        metric(f"{key}_{sub}", sv)
        for key in ("grad_norm", "param_norm", "update_ratio"):
            if _num(health.get(key)):
                metric(f"grad_health_{key}", health[key])
        return "\n".join(lines) + "\n"


def _finite_json(payload) -> str:
    """JSON with non-finite floats as null (the JSONL sink's
    _FiniteEncoder convention): a NaN loss — the exact incident you'd
    scrape during — must not make /healthz emit invalid JSON that
    strict clients (jq, fetch().json()) reject."""
    def sanitize(obj):
        if isinstance(obj, float) and not math.isfinite(obj):
            return None
        if isinstance(obj, dict):
            return {k: sanitize(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [sanitize(v) for v in obj]
        return obj

    return json.dumps(sanitize(payload))


def _render(value) -> str:
    """Exposition-format value: repr for floats (full round-trip
    precision — the JSONL-agreement property), plain int otherwise."""
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, float):
        return repr(value)
    return str(value)


# -- the HTTP plane ----------------------------------------------------------

class DebugHTTPServer(http.server.ThreadingHTTPServer):
    daemon_threads = True
    # Above the stdlib backlog of 5: a coordinated scrape/capture sweep
    # connects to every process at once.
    request_queue_size = 64
    hub: IntrospectionHub = None


def _make_handler():
    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # telemetry is the log
            pass

        def _reply(self, code: int, text: str, content_type: str) -> None:
            body = text.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            hub = self.server.hub
            if self.path == "/healthz":
                code, payload = hub.healthz()
                self._reply(code, _finite_json(payload),
                            "application/json")
            elif self.path == "/statsz":
                self._reply(200, _finite_json(hub.statsz()),
                            "application/json")
            elif self.path == "/metricsz":
                self._reply(200, hub.metrics_text(),
                            "text/plain; version=0.0.4; charset=utf-8")
            else:
                self._reply(404, json.dumps(
                    {"error": f"no route {self.path}"}), "application/json")

        def do_POST(self):
            hub = self.server.hub
            if self.path != "/profilez":
                self._reply(404, json.dumps(
                    {"error": f"no route {self.path}"}), "application/json")
                return
            if hub.capture is None:
                self._reply(404, json.dumps(
                    {"error": "profiling plane not attached (the runner "
                              "built no capture controller)"}),
                    "application/json")
                return
            try:
                length = int(self.headers.get("Content-Length", 0) or 0)
                body = json.loads(
                    self.rfile.read(length).decode("utf-8") or "{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except ValueError as exc:
                self._reply(400, json.dumps(
                    {"error": f"bad JSON body: {exc}"}), "application/json")
                return
            ok, payload = hub.capture.arm(**{
                k: body[k] for k in ("duration_s", "sample_interval_s",
                                     "max_samples", "top_k", "trigger")
                if k in body})
            # 409, not 500, on double-arm: profiler traces cannot nest, and
            # the second operator must learn a capture is already
            # running, not crash the first one's window. A refused
            # PARAMETER (no blocking phase in the payload) is 400.
            code = 200 if ok else (409 if "phase" in payload else 400)
            self._reply(code, _finite_json(payload), "application/json")

    return Handler


def make_debug_server(hub: IntrospectionHub, host: str = "127.0.0.1",
                      port: int = 0) -> DebugHTTPServer:
    """Build (but do not start) the debug server; ``port=0`` binds an
    ephemeral port (read ``server.server_address``)."""
    server = DebugHTTPServer((host, port), _make_handler())
    server.hub = hub
    return server


def start_debug_server(hub: IntrospectionHub, host: str = "127.0.0.1",
                       port: int = 0) -> DebugHTTPServer:
    """Bind and serve in a daemon thread; returns the live server (call
    ``shutdown()`` to stop — TrainTelemetry.close does)."""
    server = make_debug_server(hub, host=host, port=port)
    threading.Thread(target=server.serve_forever,
                     name="telemetry-introspect", daemon=True).start()
    return server
