"""The fleet collector: one ordered timeline for the whole fleet
(docs/observability.md "Fleet collector") — a copy of the JAX package's
``telemetry/collector.py`` (``tests/test_torch_fleet.py`` holds the two
to the same timeline from the same sink files).

A serving fleet is many processes, each with its own signal surface: every
trainer now has a live debug plane (telemetry/introspect.py), every
replica exports ``/metricsz`` (serve/tracing.py), the router serves
``/statsz`` and ``/metricsz``, and each process writes its own JSONL
sink. Nobody merges them — answering "what did the fleet look like when
replica 1 died" means hand-joining five files and three scrape formats.
The :class:`FleetCollector` owns that join:

* **concurrent scrape** — every registered :class:`Target` is probed
  once per pass, one thread per target bounded by the transport
  timeout, so one black-holed target costs max(per-target) and can
  never stale the others' samples (the ``Router.scrape_once``
  discipline). Each probe yields one schema-v1 ``obs_scrape`` record:
  the target's headline gauges plus ``staleness_s`` — seconds since the
  last GOOD sample, the number the "fleet scrape staleness" report gate
  regresses on;
* **JSONL tailing** — every registered sink file is tailed
  incrementally (offset + partial-line buffer, rotation-safe); new
  records merge into the timeline stamped with their source name;
* **one ordered timeline** — each pass's harvest (tailed records +
  scrape samples + the pass's ``obs_fleet_window`` aggregate) is sorted
  by ``(ts, source, sequence)`` and appended to the output JSONL. The
  sort is deterministic: replaying the same sources yields the same
  timeline byte for byte (out-of-order source timestamps land in
  timestamp order within the pass);
* **fleet aggregates** — one ``obs_fleet_window`` per pass: healthy /
  total target counts (the dip-and-recovery signal when a replica
  dies), fleet request rate (delta of replica request counters between
  passes), worst-replica p99 (histogram-quantile over each replica's
  exported phase-latency histogram — the "fleet worst-replica p99"
  gate), trainer step rate, max staleness, and the fleet error-budget
  burn (over-SLO counts against the configured budget);
* **coordinated capture** — :meth:`FleetCollector.trigger_profile`
  POSTs ``/profilez`` to every trainer/replica target concurrently
  (fired together, so the bounded capture windows ALIGN across the
  fleet) and records one trigger ``obs_scrape`` (``probe:
  "profilez"``) per target; the resulting ``profile_window`` records
  land in each process's sink and are tailed into the same timeline
  (``tools/obs_collect.py --profile``);
* **trace stitching** — tailed ``router_trace`` and ``serve_trace``
  records that share a trace id (the ``X-Bert-Trace`` propagation,
  docs/observability.md "Trace propagation") are joined into one
  ``trace_stitch`` record per client request: the router's winning
  attempt span is matched to the replica's ``serve_trace`` by attempt
  index and the client-observed total is decomposed into router
  overhead + network gap + replica time (the gap is the residual, so
  the decomposition sums exactly at record precision). A side that
  never shows up within :data:`STITCH_GRACE_PASSES` passes is emitted
  as ``orphan: true`` — counted, never dropped silently.

Stdlib-only and dual-loadable like the supervisor/router: imported
normally it is part of the telemetry package; loaded by FILE PATH
(``tools/obs_collect.py`` via tools/_bootstrap.py) it pulls the schema
module the same way, so the collector process never imports torch or
takes a CUDA context — it must keep collecting while the processes it
watches hang.
"""

from __future__ import annotations

import http.client
import json
import os
import sys
import threading
import time
import urllib.parse
from typing import Callable, Dict, List, Optional, Sequence, Tuple


def _load_schema():
    """Schema module both ways: package import when this module was
    imported normally, sibling file-path import when it was itself
    loaded by path (the torch-free parent property)."""
    if __package__:
        import importlib

        return importlib.import_module(
            "bert_pytorch_tpu_torch.telemetry.schema")
    import importlib.util

    module = sys.modules.get("_torchcollector_schema")
    if module is not None:
        return module
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "schema.py")
    spec = importlib.util.spec_from_file_location("_torchcollector_schema", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules["_torchcollector_schema"] = module
    spec.loader.exec_module(module)
    return module


_schema = _load_schema()
SCHEMA_VERSION = _schema.SCHEMA_VERSION
TARGET_KINDS = _schema.OBS_TARGET_KINDS

# How many collector passes an unmatched trace side may wait for its
# counterpart before it is emitted as an orphan. Router and replica
# sinks are tailed by the same pass loop, so the only real skew is one
# flush interval; three passes is generous without letting the pending
# table grow unboundedly under sustained one-sided traffic.
STITCH_GRACE_PASSES = 3
_STITCH_EPS_MS = _schema._STITCH_EPS_MS


# -- scrape transports -------------------------------------------------------

def _http_get(url: str, path: str, timeout_s: float) -> Tuple[int, str]:
    parsed = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(parsed.hostname, parsed.port,
                                      timeout=max(0.05, timeout_s))
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode("utf-8", "replace")
    finally:
        conn.close()


def _http_post_json(url: str, path: str, body: dict,
                    timeout_s: float) -> Tuple[int, str]:
    parsed = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(parsed.hostname, parsed.port,
                                      timeout=max(0.05, timeout_s))
    try:
        data = json.dumps(body).encode("utf-8")
        conn.request("POST", path, body=data,
                     headers={"Content-Type": "application/json",
                              "Content-Length": str(len(data))})
        resp = conn.getresponse()
        return resp.status, resp.read().decode("utf-8", "replace")
    finally:
        conn.close()


def parse_prometheus(text: str) -> List[Tuple[str, Dict[str, str], float]]:
    """(name, labels, value) per sample line of a text exposition."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, value_part = line.rpartition(" ")
        if not name_part:
            continue
        try:
            value = float(value_part)
        except ValueError:
            continue
        labels: Dict[str, str] = {}
        name = name_part
        if "{" in name_part and name_part.endswith("}"):
            name, _, raw = name_part.partition("{")
            for item in raw[:-1].split(","):
                if "=" in item:
                    k, _, v = item.partition("=")
                    labels[k.strip()] = v.strip().strip('"')
        out.append((name, labels, value))
    return out


def _histogram_quantile(buckets: Dict[float, float], frac: float,
                        total: Optional[float] = None) -> Optional[float]:
    """Upper-bound quantile estimate from cumulative Prometheus buckets
    (le -> cumulative count, finite bounds only). ``total`` is the TRUE
    observation count (the ``_count`` series / +Inf bucket) — without
    it the overflow observations above the largest finite bound would
    be invisible and a tail blowup would UNDER-report the quantile.
    Returns the smallest finite bound covering ``frac`` of the total,
    or the largest finite bound when the quantile sits in the +Inf
    bucket (a floor, not an average-away)."""
    if not buckets:
        return None
    bounds = sorted(buckets)
    if total is None or total < max(buckets.values()):
        total = max(buckets.values())
    if total <= 0:
        return None
    want = frac * total
    for bound in bounds:
        if buckets[bound] >= want:
            return bound
    return bounds[-1]


def scrape_trainer(url: str, timeout_s: float = 2.0) -> Optional[dict]:
    """One trainer debug-plane sample: the headline ``bert_train_*``
    gauges off /metricsz. None = unreachable."""
    try:
        status, text = _http_get(url, "/metricsz", timeout_s)
    except OSError:
        return None
    if status != 200:
        return None
    gauges: Dict[str, float] = {}
    for name, _labels, value in parse_prometheus(text):
        if name.startswith("bert_train_"):
            gauges[name[len("bert_train_"):]] = value
    if not gauges:
        return None
    # Healthy = answering AND stepping: a trainer wedged in a hung
    # collective keeps serving /metricsz (the HTTP threads are fine) —
    # only the step age vs the exported staleness bound says whether
    # training is actually advancing (the /healthz verdict, readable
    # from the same scrape). No step age yet = still warming = healthy.
    age = gauges.get("step_age_seconds")
    bound = gauges.get("stale_after_seconds")
    stepping = age is None or bound is None or age <= bound
    out = {"healthy": gauges.get("up", 0.0) >= 1.0 and stepping}
    for src, dst in (("step", "step"),
                     ("step_age_seconds", "step_age_s"),
                     ("window_steps_per_sec", "steps_per_sec"),
                     ("window_mfu", "mfu"),
                     ("nonfinite_steps_total", "nonfinite_steps"),
                     ("faults_total", "faults")):
        if src in gauges:
            out[dst] = gauges[src]
    return out


def scrape_replica(url: str, timeout_s: float = 2.0) -> Optional[dict]:
    """One serving-replica sample off /metricsz: liveness/queue gauges,
    request/error/over-SLO counters summed over task heads, and a p99
    estimate from the total-phase latency histogram."""
    try:
        status, text = _http_get(url, "/metricsz", timeout_s)
    except OSError:
        return None
    if status != 200:
        return None
    series = parse_prometheus(text)
    sums = {"requests": 0.0, "errors": 0.0, "over_slo": 0.0}
    buckets: Dict[float, float] = {}
    hist_total = 0.0
    gauges: Dict[str, float] = {}
    for name, labels, value in series:
        if name == "bert_serve_requests_total":
            sums["requests"] += value
        elif name == "bert_serve_errors_total":
            sums["errors"] += value
        elif name == "bert_serve_over_slo_total":
            sums["over_slo"] += value
        elif name == "bert_serve_phase_latency_ms_bucket" and \
                labels.get("phase") == "total":
            le = labels.get("le", "")
            if le == "+Inf":
                # The TRUE total: observations past the largest finite
                # bound live only here, and a quantile computed without
                # them under-reports exactly during a tail blowup.
                hist_total += value
            elif le:
                try:
                    bound = float(le)
                except ValueError:
                    continue
                buckets[bound] = buckets.get(bound, 0.0) + value
        elif not labels and name.startswith("bert_serve_"):
            gauges[name[len("bert_serve_"):]] = value
    if not series:
        return None
    out = {
        "healthy": gauges.get("dispatch_alive", 0.0) >= 1.0
        and gauges.get("draining", 0.0) < 1.0,
        "dispatch_alive": gauges.get("dispatch_alive", 0.0) >= 1.0,
        "draining": gauges.get("draining", 0.0) >= 1.0,
        "queue_depth": gauges.get("queue_depth", 0.0),
        "requests": sums["requests"],
        "errors": sums["errors"],
        "over_slo": sums["over_slo"],
    }
    p99 = _histogram_quantile(buckets, 0.99, total=hist_total or None)
    if p99 is not None:
        out["latency_p99_ms"] = p99
    return out


def scrape_router(url: str, timeout_s: float = 2.0) -> Optional[dict]:
    """One router sample off its JSON /statsz (the human surface; the
    router's /metricsz carries the same counters for standard
    scrapers)."""
    try:
        status, text = _http_get(url, "/statsz", timeout_s)
        stats = json.loads(text)
    except (OSError, ValueError):
        return None
    if status != 200 or not isinstance(stats, dict):
        return None
    out = {"healthy": stats.get("healthy_replicas", 0) > 0}
    for key in ("requests", "sheds", "errors", "retries",
                "failovers", "healthy_replicas", "replicas",
                "latency_p99_ms"):
        if stats.get(key) is not None:
            out[key] = stats[key]
    if stats.get("ok") is not None:
        # Renamed: the obs_scrape record's own boolean ``ok`` (did the
        # scrape succeed) must never be clobbered by the router's
        # ok-request counter.
        out["requests_ok"] = stats["ok"]
    return out


_SCRAPERS = {
    "trainer": scrape_trainer,
    "replica": scrape_replica,
    "router": scrape_router,
}


class Target:
    """One scrape target. ``scrape`` is injectable for deterministic
    tests (a callable ``url -> Optional[dict]``); production resolves it
    from ``kind``. Mutable sample state (last good sample + its clock
    time) is only touched by :meth:`FleetCollector.collect_once` under
    the collector's lock."""

    def __init__(self, name: str, kind: str, url: str,
                 scrape: Optional[Callable[[str], Optional[dict]]] = None,
                 timeout_s: float = 2.0):
        if kind not in TARGET_KINDS:
            raise ValueError(
                f"target kind must be one of {TARGET_KINDS}, got {kind!r}")
        self.name = str(name)
        self.kind = kind
        self.url = url.rstrip("/")
        self.timeout_s = float(timeout_s)
        self._scrape = scrape or (
            lambda u: _SCRAPERS[kind](u, timeout_s=self.timeout_s))
        # Sample state (collector-thread-owned, under the collector lock)
        self.last_ok_at: Optional[float] = None
        self.last_sample: Optional[dict] = None
        self.prev_sample: Optional[dict] = None
        self.prev_ok_at: Optional[float] = None
        self.failures = 0
        # Set by FleetCollector.add_target: a dynamically joined target
        # ages from its JOIN time, not from collector start — an
        # autoscaled replica added ten minutes in must not be born ten
        # minutes stale.
        self.added_at: Optional[float] = None


class JsonlTailer:
    """Incremental reader of one JSONL sink: returns only the records
    appended since the last poll. A partial trailing line stays buffered
    until its newline lands (a writer mid-line never yields a torn
    record); a truncated/rotated file restarts from the top."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = str(source)
        self._offset = 0
        self._buf = ""

    def poll(self) -> List[dict]:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size < self._offset:
            self._offset = 0  # rotated/truncated: start over
            self._buf = ""
        records: List[dict] = []
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                f.seek(self._offset)
                chunk = f.read()
                self._offset = f.tell()
        except OSError:
            return []
        data = self._buf + chunk
        lines = data.split("\n")
        self._buf = lines.pop()  # "" after a complete final line
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # the schema lint owns strictness
            if isinstance(rec, dict):
                records.append(rec)
        return records


class FleetMembership:
    """Reconcile a collector's replica targets from a supervisor's
    fleet-telemetry event stream (serve/supervisor.py).

    The scrape set used to be static at launch, which breaks under an
    elastic fleet (serve/autoscaler.py): a replica spawned mid-run never
    joins the timeline, and a drained one counts as a stale scrape
    failure forever. The supervisor's event stream is the membership
    truth, so we read it instead of inventing a side-channel status
    file: ``spawn`` announces a replica (join — idempotent by name, so
    crash-respawns of a known replica are no-ops), ``drain_complete``
    confirms a decommission and ``gave_up`` retires a crash-looping
    replica (leave). Removal waits for ``drain_complete``, not the
    ``scale_drain`` request — the same confirm-then-remove discipline
    the router uses (docs/serving.md "Elastic fleet")."""

    def __init__(self, collector: "FleetCollector", tailer: JsonlTailer,
                 host: str = "127.0.0.1", prefix: str = "replica",
                 timeout_s: float = 2.0,
                 scrape: Optional[Callable[[str], Optional[dict]]] = None):
        self._collector = collector
        self._tailer = tailer
        self._host = str(host)
        self._prefix = str(prefix)
        self._timeout_s = float(timeout_s)
        self._scrape = scrape

    def sync(self) -> dict:
        """Drain the event stream once and apply joins/leaves. Returns
        ``{"joined": [names], "left": [names]}`` for this pass."""
        joined: List[str] = []
        left: List[str] = []
        for rec in self._tailer.poll():
            if rec.get("kind") != "fleet_event":
                continue
            idx = rec.get("replica")
            if idx is None:
                continue
            name = f"{self._prefix}-{idx}"
            event = rec.get("event")
            port = rec.get("port")
            if event == "spawn" and port:
                target = Target(name, "replica",
                                f"http://{self._host}:{port}",
                                scrape=self._scrape,
                                timeout_s=self._timeout_s)
                if self._collector.add_target(target):
                    joined.append(name)
            elif event in ("drain_complete", "gave_up"):
                if self._collector.remove_target(name):
                    left.append(name)
        return {"joined": joined, "left": left}


class FleetCollector:
    """Merge scrapes + tailed sinks into one ordered timeline JSONL.

    Drive it either with a background thread (:meth:`start` /
    :meth:`stop`) or by calling :meth:`collect_once` per pass
    (deterministic tests, the chaos harness) — one lock serializes the
    two, so a manual pass and the thread never interleave a pass.
    ``emit`` optionally receives every timeline record as it is written
    (the in-memory index the E2E asserts on)."""

    def __init__(
        self,
        targets: Sequence[Target],
        tails: Sequence[JsonlTailer] = (),
        out_path: Optional[str] = None,
        emit: Optional[Callable[[dict], None]] = None,
        interval_s: float = 1.0,
        slo_error_budget: float = 0.01,
        clock: Callable[[], float] = time.monotonic,
        wall: Callable[[], float] = time.time,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self._emit_fn = emit
        self.interval_s = float(interval_s)
        self.slo_error_budget = float(slo_error_budget)
        self._clock = clock
        self._wall = wall
        self._sleep = sleep
        # One lock guards the target table, the tailers, the output
        # file, and the pass counter: collect_once may be driven by a
        # test/harness thread while the background loop runs.
        self._lock = threading.Lock()
        self._targets = list(targets)
        self._tails = list(tails)
        self._passes = 0
        # Pending trace joins keyed by router trace id: each entry holds
        # the router_trace record (if seen), the sampled serve_trace
        # records chained to it, and the pass it was first seen on (the
        # orphan-grace clock). Guarded by the collector lock like
        # everything else.
        self._stitch_pending: Dict[str, dict] = {}
        self._stitch_finalized = False
        self._started_at = clock()
        self._out_f = open(out_path, "a", encoding="utf-8") \
            if out_path else None
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- dynamic membership -----------------------------------------------

    def add_target(self, target: Target) -> bool:
        """Join a target to the scrape set mid-run (elastic fleets: a
        replica the autoscaler just spawned). Idempotent by name —
        re-announcing an existing member is a no-op, so replaying a
        supervisor event stream is safe. Returns True if added."""
        with self._lock:
            if any(t.name == target.name for t in self._targets):
                return False
            target.added_at = self._clock()
            self._targets.append(target)
            return True

    def remove_target(self, name: str) -> bool:
        """Retire a target from the scrape set (a drained replica is
        decommissioned capacity, not a stale scrape failure — leaving it
        in would poison max staleness forever). Returns True if a target
        of that name was present."""
        with self._lock:
            kept = [t for t in self._targets if t.name != name]
            removed = len(kept) != len(self._targets)
            self._targets = kept
            return removed

    def target_names(self) -> List[str]:
        with self._lock:
            return [t.name for t in self._targets]

    # -- one pass ---------------------------------------------------------

    def collect_once(self) -> Optional[dict]:
        """Scrape every target concurrently, drain every tailer, write
        the pass's records in deterministic order. Returns the pass's
        ``obs_fleet_window`` record (None only when the collector has no
        targets at all)."""
        with self._lock:
            targets = list(self._targets)
            # Concurrent probes: one bounded thread per target, results
            # by slot — the scrape_once discipline (a black-holed target
            # costs max(per-target), and its staleness is RECORDED, not
            # propagated to the others).
            results: list = [None] * len(targets)
            costs: list = [0.0] * len(targets)

            def probe(i: int, target: Target) -> None:
                t0 = self._clock()
                try:
                    results[i] = target._scrape(target.url)
                except Exception:
                    results[i] = None
                finally:
                    # Per-target cost, stamped inside the probe: the
                    # pass-level join time is the SLOWEST target's cost
                    # and must not be misattributed to the healthy ones.
                    costs[i] = self._clock() - t0

            threads = [threading.Thread(target=probe, args=(i, t),
                                        name="obs-collect-probe",
                                        daemon=True)
                       for i, t in enumerate(targets)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            now = self._clock()
            wall_ts = self._wall()
            self._passes += 1
            harvest: List[Tuple[float, int, int, dict]] = []
            scrapes = []
            for idx, (target, sample) in enumerate(zip(targets, results)):
                target.prev_sample, target.prev_ok_at = (
                    (target.last_sample, target.last_ok_at)
                    if sample is not None else
                    (target.prev_sample, target.prev_ok_at))
                if sample is not None:
                    target.failures = 0
                    staleness = 0.0
                    target.last_sample = sample
                    target.last_ok_at = now
                else:
                    target.failures += 1
                    # Never-scraped targets age from collector start:
                    # a target that was never up is maximally stale,
                    # not zero-stale. Dynamically joined targets age
                    # from their join time instead.
                    anchor = (target.last_ok_at
                              if target.last_ok_at is not None
                              else target.added_at
                              if target.added_at is not None
                              else self._started_at)
                    staleness = now - anchor
                rec = {
                    "kind": "obs_scrape", "tag": "obs",
                    "target": target.name, "target_kind": target.kind,
                    "url": target.url,
                    "ok": sample is not None,
                    "staleness_s": round(max(0.0, staleness), 3),
                    "scrape_ms": round(costs[idx] * 1000.0, 3),
                }
                if sample is not None:
                    # The scrape envelope's own fields win: a sample key
                    # colliding with ok/target/staleness_s/... must not
                    # rewrite the record's identity.
                    rec.update({k: v for k, v in sample.items()
                                if k not in rec})
                scrapes.append((target, sample, rec))
            window = self._fleet_window_locked(targets, scrapes, now)
            for tail_idx, tailer in enumerate(self._tails):
                for line_no, rec in enumerate(tailer.poll()):
                    rec = dict(rec)
                    rec.setdefault("obs_source", tailer.source)
                    ts = rec.get("ts")
                    ts = float(ts) if isinstance(ts, (int, float)) \
                        and not isinstance(ts, bool) else wall_ts
                    self._feed_stitch_locked(rec)
                    harvest.append((ts, 1 + tail_idx, line_no, rec))
            for scrape_idx, (_, _, rec) in enumerate(scrapes):
                harvest.append((wall_ts, 0, scrape_idx, rec))
            if window is not None:
                harvest.append((wall_ts, 0, len(scrapes), window))
            # Deterministic merge: timestamp order, ties broken by
            # (source index, per-source sequence) — replaying the same
            # sources reproduces the same timeline byte for byte.
            harvest.sort(key=lambda item: (item[0], item[1], item[2]))
            for ts, _, _, rec in harvest:
                self._write_locked(rec, ts)
            # Stitch AFTER the pass's harvest lands: a router_trace and
            # its serve_trace tailed in the same pass join immediately;
            # one-sided entries age toward the orphan grace.
            self._flush_stitch_locked(wall_ts, final=False)
        return window

    def _fleet_window_locked(self, targets: List[Target],
                             scrapes, now: float) -> Optional[dict]:
        if not targets:
            return None
        healthy = 0
        replicas = replicas_healthy = 0
        trainers_rate: List[float] = []
        worst_p99: Optional[float] = None
        fleet_rps = 0.0
        rps_seen = False
        over_slo = requests = 0.0
        max_staleness = 0.0
        for target, sample, rec in scrapes:
            max_staleness = max(max_staleness, rec["staleness_s"])
            ok = sample is not None and bool(sample.get("healthy"))
            healthy += 1 if ok else 0
            if target.kind == "replica":
                replicas += 1
                replicas_healthy += 1 if ok else 0
                if sample is not None:
                    p99 = sample.get("latency_p99_ms")
                    if p99 is not None:
                        worst_p99 = p99 if worst_p99 is None \
                            else max(worst_p99, p99)
                    requests += float(sample.get("requests", 0.0))
                    over_slo += float(sample.get("over_slo", 0.0))
                    prev = target.prev_sample
                    if prev is not None and target.prev_ok_at is not None \
                            and now > target.prev_ok_at:
                        delta = (float(sample.get("requests", 0.0))
                                 - float(prev.get("requests", 0.0)))
                        if delta >= 0:
                            fleet_rps += delta / (now - target.prev_ok_at)
                            rps_seen = True
            elif target.kind == "trainer" and sample is not None:
                rate = sample.get("steps_per_sec")
                if rate is not None:
                    trainers_rate.append(float(rate))
        record = {
            "kind": "obs_fleet_window", "tag": "obs",
            "targets_total": len(targets),
            "targets_healthy": healthy,
            "max_staleness_s": round(max_staleness, 3),
        }
        if replicas:
            record["replicas_total"] = replicas
            record["replicas_healthy"] = replicas_healthy
        if worst_p99 is not None:
            record["worst_replica_p99_ms"] = round(worst_p99, 3)
        if rps_seen:
            record["fleet_rps"] = round(fleet_rps, 3)
        if trainers_rate:
            record["trainer_steps_per_sec"] = round(
                sum(trainers_rate) / len(trainers_rate), 4)
        if requests > 0:
            budget = self.slo_error_budget * requests
            if budget > 0:
                record["error_budget_burn"] = round(over_slo / budget, 4)
        return record

    # -- coordinated capture ----------------------------------------------

    def trigger_profile(self, duration_s: float = 2.0,
                        params: Optional[dict] = None,
                        post: Optional[Callable] = None) -> List[dict]:
        """One ALIGNED fleet-wide capture: POST ``/profilez`` to every
        trainer/replica target concurrently (one bounded thread per
        target, all fired together — alignment is the point: the
        windows cover the same wall-clock slice, so the timeline shows
        the fleet under the same load). Routers have no capture plane
        and are skipped. Returns (and writes to the timeline) one
        trigger ``obs_scrape`` record per target, ``probe:
        "profilez"``; the captures themselves land as
        ``profile_window`` records in each process's sink and reach
        the timeline through the normal tailers. ``post`` is
        injectable for deterministic tests: ``(url, path, body,
        timeout_s) -> (status, text)``."""
        body = dict(params or {})
        body["duration_s"] = float(duration_s)
        body.setdefault("trigger", "fleet")
        do_post = post or _http_post_json
        with self._lock:
            targets = [t for t in self._targets
                       if t.kind in ("trainer", "replica")]
            results: list = [None] * len(targets)
            costs: list = [0.0] * len(targets)

            def probe(i: int, target: Target) -> None:
                t0 = self._clock()
                try:
                    status, text = do_post(target.url, "/profilez", body,
                                           target.timeout_s)
                    try:
                        payload = json.loads(text)
                    except ValueError:
                        payload = {}
                    results[i] = (status,
                                  payload if isinstance(payload, dict)
                                  else {})
                except Exception:
                    results[i] = None
                finally:
                    costs[i] = self._clock() - t0

            threads = [threading.Thread(target=probe, args=(i, t),
                                        name="obs-profile-trigger",
                                        daemon=True)
                       for i, t in enumerate(targets)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall_ts = self._wall()
            out: List[dict] = []
            for idx, (target, res) in enumerate(zip(targets, results)):
                rec = {
                    "kind": "obs_scrape", "tag": "obs",
                    "target": target.name, "target_kind": target.kind,
                    "url": target.url, "probe": "profilez",
                    "ok": res is not None and res[0] == 200,
                    "staleness_s": 0.0,
                    "scrape_ms": round(costs[idx] * 1000.0, 3),
                }
                if res is not None:
                    status, payload = res
                    rec["status"] = status
                    if payload.get("error"):
                        rec["error"] = str(payload["error"])
                    elif payload.get("armed"):
                        rec["armed_duration_s"] = payload.get("duration_s")
                else:
                    rec["error"] = "unreachable"
                out.append(rec)
                self._write_locked(rec, wall_ts)
        return out

    # -- trace stitching --------------------------------------------------

    def _feed_stitch_locked(self, rec: dict) -> None:
        """Index one tailed record into the pending-stitch table.
        Only head-sampled serve_traces enter: a slow-forced record
        (``sampled: false``) has no router_trace counterpart by
        construction (the router's sampling decision wins fleet-wide),
        so stitching it would manufacture orphans."""
        kind = rec.get("kind")
        if kind == "router_trace":
            tid = rec.get("trace_id")
            if isinstance(tid, str) and tid:
                entry = self._stitch_pending.setdefault(
                    tid, {"router": None, "replicas": [],
                          "pass": self._passes})
                entry["router"] = rec
        elif kind == "serve_trace":
            parent = rec.get("parent_trace_id")
            if isinstance(parent, str) and parent \
                    and rec.get("sampled") is True:
                entry = self._stitch_pending.setdefault(
                    parent, {"router": None, "replicas": [],
                             "pass": self._passes})
                entry["replicas"].append(rec)

    def _flush_stitch_locked(self, wall_ts: float, final: bool) -> None:
        """Emit every pending entry that is complete, expired past the
        orphan grace, or (``final``) being force-drained at close."""
        for tid in list(self._stitch_pending):
            entry = self._stitch_pending[tid]
            aged = (self._passes - entry["pass"]) >= STITCH_GRACE_PASSES
            rec = self._stitch_record(tid, entry, force=final or aged)
            if rec is not None:
                del self._stitch_pending[tid]
                self._write_locked(rec, wall_ts)

    def _stitch_record(self, tid: str, entry: dict,
                       force: bool) -> Optional[dict]:
        """One ``trace_stitch`` for a pending entry, or None to keep
        waiting. Complete = router 2xx joined to the winning attempt's
        serve_trace; router non-2xx is a non-orphan singleton (the
        router tracer only hands a request to a replica span on
        successful dispatch); anything one-sided past the grace is an
        orphan — counted, never dropped."""
        router = entry["router"]
        reps = entry["replicas"]
        if router is None:
            if not force:
                return None
            rec = {"kind": "trace_stitch", "tag": "obs", "trace_id": tid,
                   "orphan": True, "orphan_side": "router",
                   "router_spans": 0, "replica_spans": len(reps)}
            if reps:
                rec["replica_ms"] = round(
                    float(reps[0].get("total_ms", 0.0)), 3)
            return rec
        spans = router.get("spans") or []
        status = int(router.get("status", 0))
        winning = router.get("winning_attempt")
        base = {
            "kind": "trace_stitch", "tag": "obs", "trace_id": tid,
            "orphan": False,
            "router_spans": len(spans), "replica_spans": len(reps),
            "status": status,
            "task": router.get("task"),
            "attempts": int(router.get("attempts", 0)),
            "hedges": int(router.get("hedges", 0)),
            "hedge_wasted_ms": round(
                float(router.get("hedge_wasted_ms", 0.0)), 3),
            "client_total_ms": round(float(router.get("total_ms", 0.0)), 3),
        }
        if not (200 <= status < 300):
            # No replica span expected; emit immediately so error bursts
            # never pool in the pending table.
            return base
        win = None
        if winning is not None:
            win = next((r for r in reps if r.get("attempt") == winning),
                       None)
        elif len(reps) == 1:
            win = reps[0]
        if win is None:
            if not force:
                return None
            base["orphan"] = True
            base["orphan_side"] = "replica"
            return base
        wspan = next(
            (s for s in spans if s.get("name") == "attempt"
             and s.get("attempt") == win.get("attempt")), None)
        total = base["client_total_ms"]
        attempt_ms = float(wspan.get("dur_ms", 0.0)) if wspan else 0.0
        replica_ms = round(float(win.get("total_ms", 0.0)), 3)
        # Decomposition with the gap as the RESIDUAL: overhead is the
        # client total minus the winning attempt's wall time (queueing,
        # admission, backoff, hedge management), the gap is whatever the
        # attempt spent outside the replica (network + HTTP framing +
        # cross-process clock noise) — so the three parts sum to the
        # client total EXACTLY at record precision, and the schema's
        # decomposition identity holds by construction.
        overhead = round(max(0.0, total - attempt_ms), 3)
        gap = round(total - overhead - replica_ms, 3)
        base.update({
            "router_overhead_ms": overhead,
            "network_gap_ms": gap,
            "replica_ms": replica_ms,
            # Slightly negative gaps are unsynchronized-clock noise, not
            # broken stitching; anything past the epsilon is flagged.
            "consistent": bool(gap >= -_STITCH_EPS_MS),
            "winning_attempt": int(win.get("attempt", 1)),
            "winning_trace_id": win.get("trace_id"),
        })
        if win.get("obs_source"):
            base["winning_source"] = win["obs_source"]
        rep_spans = win.get("spans") or []
        if rep_spans:
            dominant = max(rep_spans,
                           key=lambda s: float(s.get("dur_ms", 0.0)))
            base["replica_critical_phase"] = dominant.get("name")
        return base

    def _write_locked(self, rec: dict, ts: float) -> None:
        out = dict(rec)
        out.setdefault("schema", SCHEMA_VERSION)
        out.setdefault("ts", round(ts, 3))
        if self._out_f is not None:
            self._out_f.write(json.dumps(out) + "\n")
            self._out_f.flush()
        if self._emit_fn is not None:
            try:
                self._emit_fn(out)
            except Exception:
                pass  # observability must never take the collector down

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._stop_event.clear()
        self._thread = threading.Thread(
            target=self._loop, name="obs-collector", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop_event.is_set():
            self.collect_once()
            self._sleep(self.interval_s)

    def stop(self) -> None:
        """Stop the background loop, run one final pass (drain anything
        the sinks appended since the last tick), close the output.
        Manual callers (the CLI's own pass loop) that already ran their
        last pass use :meth:`close` instead — stop()'s drain pass would
        be an extra, uncounted round."""
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.collect_once()
        self.close()

    def close(self) -> None:
        """Close the timeline output without another pass. Pending trace
        joins are force-drained first — an entry still waiting for its
        counterpart becomes an orphan stitch rather than vanishing with
        the process."""
        with self._lock:
            if not self._stitch_finalized:
                self._stitch_finalized = True
                self._flush_stitch_locked(self._wall(), final=True)
            if self._out_f is not None:
                self._out_f.close()
                self._out_f = None

    def passes(self) -> int:
        with self._lock:
            return self._passes


def stitch_tree(records: Sequence[dict], trace_id: str) -> str:
    """Render one client request's stitched trace as an indented tree
    (``tools/obs_collect.py --trace <id>``): the router's span taxonomy
    in dispatch order, each attempt's replica ``serve_trace`` phases
    nested under the attempt that reached it, and the stitch verdict
    last. Works on any record iterable — a timeline read back from
    disk, or the chaos harness's in-memory index."""
    router = None
    stitch = None
    reps_by_id: Dict[str, dict] = {}
    for rec in records:
        kind = rec.get("kind")
        if kind == "router_trace" and rec.get("trace_id") == trace_id:
            router = rec
        elif kind == "serve_trace" \
                and rec.get("parent_trace_id") == trace_id:
            # Dedup by the replica's own trace id (the same record can
            # reach a merged iterable twice, e.g. sink + timeline); the
            # copy carrying obs_source attribution wins.
            key = str(rec.get("trace_id"))
            if key not in reps_by_id or rec.get("obs_source"):
                reps_by_id[key] = rec
        elif kind == "trace_stitch" and rec.get("trace_id") == trace_id:
            stitch = rec
    reps = list(reps_by_id.values())
    if router is None and stitch is None and not reps:
        return f"trace {trace_id}: not found in timeline"

    lines: List[str] = []
    by_attempt: Dict[int, List[dict]] = {}
    for rep in reps:
        by_attempt.setdefault(int(rep.get("attempt", 1)), []).append(rep)

    def replica_lines(rep: dict, indent: str, span_indent: str) -> None:
        src = f" ({rep['obs_source']})" if rep.get("obs_source") else ""
        lines.append(
            f"{indent}serve_trace {rep.get('trace_id', '?')}{src}"
            f"  total={rep.get('total_ms', '?')}ms"
            f"  reason={rep.get('sample_reason', '?')}")
        for span in rep.get("spans") or []:
            lines.append(
                f"{span_indent}{span.get('name', '?'):<12}"
                f"@{span.get('start_ms', 0)}ms"
                f"  +{span.get('dur_ms', 0)}ms")

    if router is not None:
        winning = router.get("winning_attempt")
        lines.append(
            f"trace {trace_id}  task={router.get('task', '?')}"
            f"  status={router.get('status', '?')}"
            f"  client_total={router.get('total_ms', '?')}ms"
            f"  attempts={router.get('attempts', '?')}"
            f"  hedges={router.get('hedges', 0)}")
        for span in router.get("spans") or []:
            name = span.get("name", "?")
            head = (f"├─ router {name:<9}"
                    f"@{span.get('start_ms', 0)}ms"
                    f"  +{span.get('dur_ms', 0)}ms")
            if name == "attempt":
                att = span.get("attempt")
                marks = []
                if span.get("hedge"):
                    marks.append("hedge")
                if winning is not None and att == winning:
                    marks.append("win")
                mark = f"  [{','.join(marks)}]" if marks else ""
                head += (f"  #{att} -> {span.get('replica', '?')}"
                         f"  outcome={span.get('outcome', '?')}{mark}")
            lines.append(head)
            if name == "attempt":
                for rep in by_attempt.get(span.get("attempt"), ()):  # type: ignore[arg-type]
                    replica_lines(rep, "│    └─ ", "│       ")
        matched = {s.get("attempt")
                   for s in router.get("spans") or []
                   if s.get("name") == "attempt"}
        strays = [rep for rep in reps
                  if int(rep.get("attempt", 1)) not in matched]
    else:
        lines.append(f"trace {trace_id}  (no router_trace span — orphan)")
        strays = reps
    for rep in strays:
        lines.append(f"├─ unmatched replica attempt "
                     f"{rep.get('attempt', '?')}")
        replica_lines(rep, "│    └─ ", "│       ")
    if stitch is not None:
        if stitch.get("orphan"):
            lines.append(
                f"└─ stitch: ORPHAN ({stitch.get('orphan_side', '?')} "
                f"side missing)  router_spans="
                f"{stitch.get('router_spans')}"
                f"  replica_spans={stitch.get('replica_spans')}")
        else:
            lines.append(
                f"└─ stitch: overhead={stitch.get('router_overhead_ms')}ms"
                f"  gap={stitch.get('network_gap_ms')}ms"
                f"  replica={stitch.get('replica_ms')}ms"
                f"  == client {stitch.get('client_total_ms')}ms"
                f"  consistent={stitch.get('consistent')}"
                f"  critical={stitch.get('replica_critical_phase', '-')}")
    else:
        lines.append("└─ stitch: (pending — no trace_stitch record yet)")
    return "\n".join(lines)
