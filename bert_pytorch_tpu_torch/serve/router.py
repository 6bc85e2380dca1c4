"""Fleet router: health-gated balancing, bounded failover, hedging,
brownout (The Tail at Scale §"Within Request Short-Term
Adaptations") — a copy of the JAX package's ``serve/router.py``, kept
decision for decision (``tests/test_torch_fleet.py`` holds the two to
the same records), in front of the port's ``run_server`` replicas.

The front tier in front of N serving replicas (serve/supervisor.py).
One :class:`Router` owns a replica table fed by a background scrape of
each replica's ``/metricsz`` gauges (queue depth, draining,
dispatch-thread liveness — the replicas' metrics plane) and serves
the SAME JSON API the replicas do (``POST /v1/<task>``), so a client
cannot tell one engine from a fleet. Per request it applies, in order:

* **admission** — only replicas that are healthy (scrape fresh, dispatch
  alive, not draining) are candidates; if every candidate's queue depth
  is at the brownout threshold (or none are healthy at all) the request
  is SHED with 503 + ``Retry-After`` rather than queued into a latency
  cliff;
* **least-queue-depth balancing** — among candidates, route to the
  smallest (scraped queue depth + router-local in-flight);
* **per-request deadline** — every dispatch, backoff, and hedge wait is
  bounded by one deadline; when it passes the client gets a definite
  answer, never a hang;
* **bounded retry on a DIFFERENT replica** — a transport failure or
  5xx puts the replica on the request's exclude list and the request on
  the next-best candidate after a full-jitter backoff
  (``utils/retry.py``), bounded by both an attempt count and the
  deadline. 4xx answers are returned as-is (a bad payload is bad on
  every replica; retrying it would triple the error load);
* **hedged requests** — once enough latency history exists, a dispatch
  that has outlived the configured percentile of recent latencies fires
  ONE duplicate on the next-best replica and takes whichever answers
  first — the tail-at-scale hedge, budgeted (one hedge per request,
  only past the percentile) so added load stays a few percent;
* **canary traffic splitting** — with a split installed
  (:meth:`Router.set_split`, driven by serve/rollout.py), a salted
  deterministic hash of the request sequence sends ``share`` of the
  task's traffic to replicas serving the canary version and the rest
  away from them — a SOFT preference (availability beats cohort
  purity; fallbacks are counted). Per-cohort outcome windows
  (:meth:`Router.split_window`) are the rollout controller's SLO
  evidence, and per-version routed counters export as
  ``bert_router_version_requests``.

Every ``window`` completed requests emit one schema-v1 ``router_window``
record (ok/shed/error decomposition, retry/hedge/failover counters,
latency and failover percentiles) — telemetry-report's "router
failover" gate reads them.

Stdlib-only and dual-loadable by file path (tools/chaos_serve.py) like
the supervisor: the router process must never import torch or take a
CUDA context.
"""

from __future__ import annotations

import collections
import http.client
import http.server
import inspect
import json
import os
import queue
import sys
import threading
import time
import urllib.parse
import uuid
from typing import Callable, Dict, List, Optional, Sequence, Tuple


def _load_util(modname: str):
    """See serve/supervisor.py — package import normally, file-path
    import when this module itself was loaded by path (torch-free)."""
    if __package__:
        import importlib

        return importlib.import_module(f"bert_pytorch_tpu_torch.utils.{modname}")
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "utils", f"{modname}.py")
    spec = importlib.util.spec_from_file_location(
        f"_torchrouter_{modname}", path)
    module = sys.modules.get(f"_torchrouter_{modname}")
    if module is not None:
        return module
    module = importlib.util.module_from_spec(spec)
    sys.modules[f"_torchrouter_{modname}"] = module
    spec.loader.exec_module(module)
    return module


RetryPolicy = _load_util("retry").RetryPolicy


def _load_telemetry(modname: str):
    """Same dual-load trick for telemetry modules (all stdlib-only):
    Heartbeat lives in telemetry/sentinels.py, and the router writes the
    SAME resumable liveness file the training loop and serve replicas
    write, so one watchdog contract covers every tier."""
    if __package__:
        import importlib

        return importlib.import_module(
            f"bert_pytorch_tpu_torch.telemetry.{modname}")
    import importlib.util

    name = f"_torchrouter_tel_{modname}"
    module = sys.modules.get(name)
    if module is not None:
        return module
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "telemetry", f"{modname}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module

# Statuses worth trying on another replica: server-side trouble that is
# plausibly replica-local (a draining or saturated or crashed replica).
# Everything else — 2xx, 4xx — is final: the answer would be the same
# fleet-wide, and retrying a client error only multiplies it.
RETRYABLE_STATUSES = frozenset((500, 502, 503, 504))

_SAMPLE_CAP = 512  # recent-latency history for the hedge threshold

# -- cross-tier trace propagation ---------------------------------------------
# The router mints one fleet-unique trace id + head-sampling decision per
# client request and forwards them on EVERY dispatch attempt; the replica
# adopts the decision (serve/tracing.py parse_trace_header) so sampling
# is consistent fleet-wide, and both tiers echo the id back so clients
# correlate without relying on sampling. The wire format is duplicated
# from serve/tracing.py on purpose: this module stays stdlib-only and
# dual-loadable by file path (no serve-package imports); the round-trip
# is pinned by tests/test_fleet_tracing.py.
TRACE_HEADER = "X-Bert-Trace"
TRACE_ID_RESPONSE_HEADER = "X-Bert-Trace-Id"


def format_trace_header(trace_id: str, attempt: int,
                        sampled: bool) -> str:
    """``X-Bert-Trace`` request-header value for one dispatch attempt
    (serve/tracing.py parse_trace_header is the inverse)."""
    return f"{trace_id};attempt={int(attempt)};sampled={1 if sampled else 0}"


def _sample_hash(seq: int) -> float:
    """Deterministic [0, 1) hash of the request sequence number (the
    Knuth multiplicative hash serve/tracing.py uses, duplicated for the
    same dual-load reason as the wire format)."""
    return ((int(seq) * 2654435761) & 0xFFFFFFFF) / float(1 << 32)


# Golden-ratio salt decorrelating the canary-cohort hash from the
# trace-sampling hash of the SAME sequence number — without it the
# canary cohort and the sampled-trace set would be the same requests
# whenever the rates matched, and the canary's latency evidence would
# carry the tracing overhead as a confound.
_SPLIT_SALT = 0x9E3779B9


def _split_hash(seq: int) -> float:
    """Deterministic [0, 1) cohort hash for canary traffic splitting
    (serve/rollout.py): the same request sequence number always lands
    in the same cohort at a given share, and growing the share only
    ADDS members (hash < share is monotone in share) — a request never
    flaps between versions as the rollout advances."""
    return _sample_hash(int(seq) ^ _SPLIT_SALT)


def _transport_takes_headers(transport) -> bool:
    """Does the injected transport accept the trace-propagation
    ``headers`` kwarg? Tests and older harnesses inject 4-arg
    transports; the router must keep working with them (trace headers
    are then simply not forwarded on that path)."""
    try:
        sig = inspect.signature(transport)
    except (TypeError, ValueError):
        return False
    params = sig.parameters.values()
    if any(p.kind == p.VAR_KEYWORD for p in params):
        return True
    return "headers" in sig.parameters


def _pctl(sorted_vals: List[float], frac: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              int(frac * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


class ReplicaState:
    """Router-side view of one replica (every field is read/written
    under ``Router._lock``)."""

    def __init__(self, url: str, index: int):
        self.url = url.rstrip("/")
        self.index = index
        self.healthy = False        # never routed to until a good scrape
        self.draining = False
        self.dispatch_alive = False
        self.queue_depth = 0
        # Pending + in-flight across the replica's whole dispatch plane
        # (bert_serve_unfinished): the honest load signal — queue_depth
        # reads 0 the instant a batch pops, so a replica mid-batch (or
        # mid-pipeline) scraped as idle and soaked up traffic it could
        # not absorb. None when the replica predates the gauge.
        self.unfinished: Optional[int] = None
        self.inflight = 0           # router-local outstanding dispatches
        self.scrape_failures = 0
        self.requests = 0           # routed to this replica (run total)
        # Serving model version the replica last reported (its
        # bert_serve_serving_version label / healthz "version" field).
        # None until a scrape carries one — canary preference treats an
        # unknown version as NOT the canary (control traffic may land
        # there; canary traffic will not).
        self.version: Optional[str] = None

    def eligible(self) -> bool:
        return self.healthy and self.dispatch_alive and not self.draining

    def load(self) -> int:
        """Scraped load for balancing and brownout admission: prefer
        ``unfinished`` (pending + in-flight), fall back to the bare
        queue depth for replicas that do not export it."""
        return (self.unfinished if self.unfinished is not None
                else self.queue_depth)


class RouterShed(RuntimeError):
    """Request shed by admission control (brownout / no healthy
    replica); carries the Retry-After hint."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = retry_after_s


def default_transport(url: str, task: str, payload: dict,
                      timeout_s: float,
                      headers: Optional[Dict[str, str]] = None
                      ) -> Tuple[int, dict]:
    """POST ``payload`` to ``url``/v1/``task``; returns (status, body).
    Raises OSError-family errors on transport failure (connection
    refused/reset, timeout) — the retry-on-another-replica signal.
    ``headers`` are extra request headers (the router's ``X-Bert-Trace``
    propagation rides here)."""
    parsed = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(
        parsed.hostname, parsed.port, timeout=max(0.05, timeout_s))
    try:
        body = json.dumps(payload).encode("utf-8")
        send_headers = {"Content-Type": "application/json"}
        send_headers.update(headers or {})
        conn.request("POST", f"/v1/{task}", body=body,
                     headers=send_headers)
        resp = conn.getresponse()
        data = resp.read()
        try:
            decoded = json.loads(data.decode("utf-8")) if data else {}
        except ValueError:
            decoded = {"error": data.decode("utf-8", "replace")[:200]}
        return resp.status, decoded
    finally:
        conn.close()


def default_scrape(url: str, timeout_s: float = 2.0) -> Optional[dict]:
    """One replica health sample: the ``/metricsz`` gauges (queue depth,
    draining, dispatch liveness) when the replica exports them, else the
    ``/healthz`` JSON. None = unreachable."""
    parsed = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(
        parsed.hostname, parsed.port, timeout=timeout_s)
    try:
        try:
            conn.request("GET", "/metricsz")
            resp = conn.getresponse()
            text = resp.read().decode("utf-8", "replace")
        except OSError:
            return None
        if resp.status == 200:
            gauges: Dict[str, float] = {}
            version: Optional[str] = None
            for line in text.splitlines():
                if line.startswith("bert_serve_serving_version{"):
                    # Info-style gauge: the version rides the label, the
                    # value is a constant 1 (serve/service.py).
                    start = line.find('version="')
                    if start >= 0:
                        start += len('version="')
                        end = line.find('"', start)
                        if end > start:
                            version = line[start:end]
                    continue
                if line.startswith("bert_serve_") and " " in line:
                    name, _, value = line.partition(" ")
                    try:
                        gauges[name] = float(value)
                    except ValueError:
                        continue
            if "bert_serve_dispatch_alive" in gauges:
                health = {
                    "dispatch_alive":
                        gauges["bert_serve_dispatch_alive"] >= 1.0,
                    "draining": gauges.get("bert_serve_draining", 0) >= 1.0,
                    "queue_depth":
                        int(gauges.get("bert_serve_queue_depth", 0)),
                }
                if "bert_serve_unfinished" in gauges:
                    # Pending + in-flight: the load signal balancing and
                    # brownout prefer (a mid-batch replica's queue_depth
                    # reads 0; its unfinished does not).
                    health["unfinished"] = int(
                        gauges["bert_serve_unfinished"])
                if version is not None:
                    health["version"] = version
                return health
        # No tracer on the replica (404) or gauges missing: /healthz
        # carries the same liveness/drain/queue facts as JSON.
        try:
            conn.close()
            conn.connect()
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            health = json.loads(resp.read().decode("utf-8", "replace"))
        except (OSError, ValueError):
            return None
        result = {
            "dispatch_alive": bool(health.get("dispatch_alive")),
            "draining": bool(health.get("draining")),
            "queue_depth": int(health.get("queue_depth", 0)),
        }
        if health.get("unfinished") is not None:
            result["unfinished"] = int(health["unfinished"])
        if health.get("version"):
            # Chaos replicas run without a tracer; /healthz carries the
            # serving version so canary routing still works there.
            result["version"] = str(health["version"])
        return result
    finally:
        conn.close()


class Router:
    def __init__(
        self,
        replica_urls: Sequence[str],
        emit: Optional[Callable[[dict], None]] = None,
        window: int = 64,
        transport: Callable[[str, str, dict, float],
                            Tuple[int, dict]] = default_transport,
        scrape: Callable[[str], Optional[dict]] = default_scrape,
        scrape_interval_s: float = 0.5,
        scrape_failures_unhealthy: int = 2,
        deadline_s: float = 15.0,
        retry_policy: Optional[RetryPolicy] = None,
        hedge_pctl: float = 0.95,
        hedge_min_ms: float = 20.0,
        hedge_min_samples: int = 32,
        brownout_queue_depth: int = 128,
        shed_retry_after_s: float = 1.0,
        trace_sample_rate: float = 0.0,
        heartbeat_file: Optional[str] = None,
        heartbeat_interval_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if not replica_urls:
            raise ValueError("need at least one replica URL")
        if not 0.0 <= float(trace_sample_rate) <= 1.0:
            raise ValueError(
                f"trace_sample_rate must be in [0, 1], got "
                f"{trace_sample_rate}")
        self._emit_fn = emit
        self.window = max(1, int(window))
        self._transport = transport
        self._transport_headers = _transport_takes_headers(transport)
        # Fleet-wide head sampling: the router's decision per
        # client request wins over every replica's local rate, so one
        # sampled request yields spans on BOTH tiers (the stitchable
        # tree) instead of two uncorrelated coin flips.
        self.trace_sample_rate = float(trace_sample_rate)
        self._trace_token = uuid.uuid4().hex[:8]
        self._trace_seq = 0
        self._scrape = scrape
        self.scrape_interval_s = float(scrape_interval_s)
        self.scrape_failures_unhealthy = int(scrape_failures_unhealthy)
        self.deadline_s = float(deadline_s)
        # Full jitter + short base: a dead replica fails dozens of
        # requests at the same instant, and their retries must not land
        # on the survivor in one synchronized wave.
        self.retry_policy = retry_policy or RetryPolicy(
            attempts=3, base_delay_s=0.05, max_delay_s=1.0,
            full_jitter=True)
        self.hedge_pctl = float(hedge_pctl)
        self.hedge_min_ms = float(hedge_min_ms)
        self.hedge_min_samples = int(hedge_min_samples)
        self.brownout_queue_depth = int(brownout_queue_depth)
        self.shed_retry_after_s = float(shed_retry_after_s)
        self._clock = clock
        self._sleep = sleep
        # One lock guards the replica table, the latency history, and
        # the window/run counters: scrape thread + every router worker
        # thread mutate them.
        self._lock = threading.Lock()
        self._replicas = [ReplicaState(url, i)
                          for i, url in enumerate(replica_urls)]
        # Monotone target-index mint for add_target (under _lock): a
        # removed slot's index stays retired, so per-target telemetry
        # is never conflated across membership generations.
        self._next_target_index = len(self._replicas)
        self._latencies = collections.deque(maxlen=_SAMPLE_CAP)
        self._win = self._zero_window()
        self._run = self._zero_window()
        # Canary traffic split (serve/rollout.py drives it): one split
        # at a time, {task, version, share, fallbacks, canary, control}
        # with a per-cohort outcome accumulator. Per-version routed
        # counters live for the whole run (the
        # bert_router_version_requests export). Both under _lock — the
        # request threads book outcomes while the rollout controller
        # reads/resets windows.
        self._split: Optional[dict] = None
        self._version_requests: Dict[str, int] = {}
        self._stop_event = threading.Event()
        self._scrape_thread: Optional[threading.Thread] = None
        # Router heartbeat: the same resumable liveness file the trainer
        # and replicas write (telemetry/sentinels.py), step = routed
        # requests — counter resumes across restarts, so "did the router
        # route anything lately" is one file read for any watchdog.
        # Beaten only from the scrape thread (Heartbeat.beat is
        # single-owner by design) plus one final flush in stop() after
        # that thread is joined; the binding itself is frozen.
        self._heartbeat = (
            _load_telemetry("sentinels").Heartbeat(heartbeat_file)
            if heartbeat_file else None)
        self._heartbeat_interval_s = float(heartbeat_interval_s)

    @staticmethod
    def _zero_window() -> dict:
        return {"requests": 0, "ok": 0, "sheds": 0, "errors": 0,
                "retries": 0, "hedges": 0, "hedge_wins": 0,
                "hedge_wasted_ms": 0.0,
                "failovers": 0, "latency_ms": [], "failover_ms": []}

    @staticmethod
    def _zero_cohort() -> dict:
        return {"requests": 0, "ok": 0, "sheds": 0, "errors": 0,
                "latency_ms": []}

    def _mint_trace(self) -> Tuple[str, bool, int]:
        """One fleet-unique trace id + head-sampling decision per client
        request (plus the raw sequence number — the canary cohort hash
        reuses it). The run token namespaces ids across router restarts
        (serve/tracing.py discipline); the sequence hash keeps sampling
        deterministic for replayed bursts."""
        with self._lock:
            seq = self._trace_seq
            self._trace_seq += 1
        sampled = (self.trace_sample_rate > 0.0
                   and _sample_hash(seq) < self.trace_sample_rate)
        return f"rt-{self._trace_token}-{seq:x}", sampled, seq

    # -- canary traffic split (serve/rollout.py) --------------------------

    def set_split(self, task: str, version: str, share: float) -> None:
        """Install or widen the canary split: ``share`` of ``task``
        traffic (by deterministic request hash) PREFERS replicas serving
        ``version``; the rest avoids them. One split at a time — a
        second (task, version) must wait for :meth:`clear_split`."""
        share = float(share)
        if not 0.0 <= share <= 1.0:
            raise ValueError(f"share must be in [0, 1], got {share}")
        with self._lock:
            if self._split is not None and (
                    self._split["task"] != task
                    or self._split["version"] != version):
                raise RuntimeError(
                    "a different split is already active "
                    f"({self._split['task']}/{self._split['version']}); "
                    "clear_split() first")
            if self._split is None:
                self._split = {
                    "task": str(task), "version": str(version),
                    "share": share, "fallbacks": 0,
                    "canary": self._zero_cohort(),
                    "control": self._zero_cohort(),
                }
            else:
                self._split["share"] = share

    def clear_split(self) -> None:
        """Drop the canary split (rollout promoted or rolled back);
        routing goes back to pure least-loaded."""
        with self._lock:
            self._split = None

    def split_window(self, reset: bool = True) -> Optional[dict]:
        """Per-cohort outcome window since the last reset — the rollout
        controller's SLO evidence. None when no split is active."""
        with self._lock:
            if self._split is None:
                return None
            out = {"task": self._split["task"],
                   "version": self._split["version"],
                   "share": self._split["share"],
                   "fallbacks": self._split["fallbacks"]}
            for cohort in ("canary", "control"):
                acc = self._split[cohort]
                summary = {"requests": acc["requests"], "ok": acc["ok"],
                           "errors": acc["errors"], "sheds": acc["sheds"]}
                lat = sorted(acc["latency_ms"])
                if lat:
                    summary.update(
                        latency_p50_ms=round(_pctl(lat, 0.50), 3),
                        latency_p95_ms=round(_pctl(lat, 0.95), 3),
                        latency_p99_ms=round(_pctl(lat, 0.99), 3))
                out[cohort] = summary
                if reset:
                    self._split[cohort] = self._zero_cohort()
            if reset:
                self._split["fallbacks"] = 0
            return out

    # -- health scraping --------------------------------------------------

    def start(self) -> None:
        """Start the background health scrape; do one synchronous pass
        first so the router is immediately routable when replicas are
        already up."""
        self.scrape_once()
        self._stop_event.clear()
        self._scrape_thread = threading.Thread(
            target=self._scrape_loop, name="router-scrape", daemon=True)
        self._scrape_thread.start()

    def _scrape_loop(self) -> None:
        # last_beat stays a local: beat cadence state is owned by this
        # thread alone (same discipline as serve/service.py's loops).
        last_beat = 0.0
        while not self._stop_event.is_set():
            self.scrape_once()
            last_beat = self._maybe_beat(last_beat)
            self._sleep(self.scrape_interval_s)

    def _maybe_beat(self, last_beat: float) -> float:
        """Beat the liveness file with step = routed requests; called
        only from the scrape thread (and once from stop() after that
        thread is joined — ownership passes to the stopping thread)."""
        if self._heartbeat is None:
            return last_beat
        now = self._clock()
        if now - last_beat < self._heartbeat_interval_s:
            return last_beat
        with self._lock:
            routed = self._run["requests"]
        self._heartbeat.beat(routed)
        return now

    def scrape_once(self) -> None:
        """One health pass over every replica (public so tests and the
        chaos harness can drive deterministic scrapes)."""
        with self._lock:
            targets = list(self._replicas)
        # One thread per replica: each probe is bounded by the scrape
        # transport's own timeout, and probing CONCURRENTLY makes the
        # pass cost max(per-replica) instead of sum — one black-holed
        # replica must not stale every other replica's gauges for its
        # full timeout (the balancing and brownout decisions read them).
        results: list = [None] * len(targets)

        def probe(i: int, rep: ReplicaState) -> None:
            try:
                results[i] = (rep, self._scrape(rep.url))
            except Exception:
                results[i] = (rep, None)

        threads = [threading.Thread(target=probe, args=(i, rep),
                                    name="router-scrape-probe", daemon=True)
                   for i, rep in enumerate(targets)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        with self._lock:
            for rep, health in results:
                if health is None:
                    rep.scrape_failures += 1
                    if rep.scrape_failures >= \
                            self.scrape_failures_unhealthy:
                        rep.healthy = False
                    continue
                rep.scrape_failures = 0
                rep.healthy = True
                rep.dispatch_alive = bool(health.get("dispatch_alive"))
                rep.draining = bool(health.get("draining"))
                rep.queue_depth = int(health.get("queue_depth", 0))
                unfinished = health.get("unfinished")
                rep.unfinished = (int(unfinished)
                                  if unfinished is not None else None)
                if health.get("version"):
                    rep.version = str(health["version"])

    # -- balancing / admission -------------------------------------------

    def _admit(self, exclude: frozenset,
               prefer_version: Optional[str] = None,
               avoid_version: Optional[str] = None) -> ReplicaState:
        """Least-loaded eligible replica, or raise :class:`RouterShed`
        (brownout: every eligible replica saturated; outage: none
        eligible at all). Load is ``ReplicaState.load()`` — unfinished
        (pending + in-flight) when the replica exports it, else queue
        depth — so a replica mid-batch no longer scrapes as idle.

        ``prefer_version`` / ``avoid_version`` are the canary split's
        SOFT version preference: when the preferred sub-pool is empty or
        fully saturated the request falls back to the whole candidate
        set (counted into the split's ``fallbacks``) — availability
        always beats cohort purity; a rollout that could strand traffic
        behind a dead canary would turn every canary crash into a client
        outage."""
        with self._lock:
            candidates = [rep for rep in self._replicas
                          if rep.eligible() and rep.url not in exclude]
            if not candidates:
                raise RouterShed(
                    "no healthy replica available", self.shed_retry_after_s)
            if all(rep.load() >= self.brownout_queue_depth
                   for rep in candidates):
                raise RouterShed(
                    "every healthy replica is saturated "
                    f"(unfinished >= {self.brownout_queue_depth}); "
                    "brownout shed", self.shed_retry_after_s)
            pool = candidates
            if prefer_version is not None or avoid_version is not None:
                if prefer_version is not None:
                    preferred = [rep for rep in candidates
                                 if rep.version == prefer_version]
                else:
                    preferred = [rep for rep in candidates
                                 if rep.version != avoid_version]
                preferred = [rep for rep in preferred
                             if rep.load() < self.brownout_queue_depth]
                if preferred:
                    pool = preferred
                elif self._split is not None:
                    self._split["fallbacks"] += 1
            chosen = min(pool,
                         key=lambda r: (r.load() + r.inflight,
                                        r.inflight, r.index))
            chosen.inflight += 1
            chosen.requests += 1
            self._version_requests[chosen.version or "unknown"] = \
                self._version_requests.get(chosen.version or "unknown",
                                           0) + 1
            return chosen

    def _release(self, rep: ReplicaState, failed: bool) -> None:
        with self._lock:
            rep.inflight = max(0, rep.inflight - 1)
            if failed:
                # Fast feedback: don't route more requests here until a
                # scrape proves it back; the scrape thread re-heals it.
                rep.healthy = False

    def _hedge_delay_s(self) -> Optional[float]:
        """Seconds a dispatch may run before its hedge fires: the
        configured percentile of recent latencies, floored at
        ``hedge_min_ms``. None = hedging disabled (pctl <= 0) or not
        enough history to know what 'slow' means yet."""
        if self.hedge_pctl <= 0:
            return None
        with self._lock:
            if len(self._latencies) < self.hedge_min_samples:
                return None
            samples = sorted(self._latencies)
        return max(self.hedge_min_ms / 1000.0,
                   _pctl(samples, self.hedge_pctl))

    def note_latency(self, seconds: float) -> None:
        """Feed one successful-dispatch latency into the hedge-threshold
        history (also called internally on every success)."""
        with self._lock:
            self._latencies.append(float(seconds))

    # -- the request path -------------------------------------------------

    def handle(self, task: str, payload: dict
               ) -> Tuple[int, dict, Dict[str, str]]:
        """Route one request end to end: (status, body, extra headers).
        Never raises — every outcome is an HTTP answer, including the
        deadline (503), brownout (503 + Retry-After), and exhausted
        retries (502). Every answer carries ``X-Bert-Trace-Id`` (sampled
        or not), and a head-sampled request additionally emits ONE
        ``router_trace`` record: admission / per-attempt dispatch /
        backoff spans plus the hedge win/waste accounting — the
        router-tier half of the stitched end-to-end tree
        (telemetry/collector.py)."""
        t0 = self._clock()
        trace_id, sampled, seq = self._mint_trace()
        # Canary cohort (serve/rollout.py): a salted hash of the SAME
        # sequence number splits traffic deterministically — same
        # request number, same cohort, and growing the share only adds
        # members. Computed once here; the preference rides every
        # admission and hedge pick for this request.
        with self._lock:
            split = (dict(self._split)
                     if self._split is not None else None)
        cohort: Optional[str] = None
        prefer_version: Optional[str] = None
        avoid_version: Optional[str] = None
        if split is not None and split["task"] == task:
            if _split_hash(seq) < split["share"]:
                cohort = "canary"
                prefer_version = split["version"]
            else:
                cohort = "control"
                avoid_version = split["version"]
        deadline = t0 + self.deadline_s
        exclude: set = set()
        rounds = 0
        failed_rounds = 0
        hedges_fired = 0
        hedge_wasted_s = 0.0
        spans: List[dict] = []
        attempt_base = 1

        def finish(status: int, body: dict, extra: Optional[dict] = None,
                   ok: bool = False, shed: bool = False,
                   hedge_won: bool = False, failover: bool = False,
                   winning_attempt: Optional[int] = None
                   ) -> Tuple[int, dict, Dict[str, str]]:
            self._observe(ok=ok, shed=shed, t0=t0, retries=failed_rounds,
                          hedges=hedges_fired, hedge_won=hedge_won,
                          failover=failover,
                          hedge_wasted_ms=hedge_wasted_s * 1000.0,
                          cohort=cohort)
            if sampled:
                self._emit_trace(
                    trace_id, task, status, t0, spans,
                    hedges=hedges_fired, hedge_won=hedge_won,
                    hedge_wasted_s=hedge_wasted_s,
                    winning_attempt=winning_attempt)
            headers = {TRACE_ID_RESPONSE_HEADER: trace_id}
            headers.update(extra or {})
            return status, body, headers

        while True:
            t_admit = self._clock()
            try:
                replica = self._admit(frozenset(exclude),
                                      prefer_version=prefer_version,
                                      avoid_version=avoid_version)
            except RouterShed as shed:
                spans.append(self._span("admission", t0, t_admit))
                return finish(503, {"error": str(shed)},
                              {"Retry-After": f"{shed.retry_after_s:g}"},
                              shed=True)
            spans.append(self._span("admission", t0, t_admit))
            remaining = deadline - self._clock()
            if remaining <= 0:
                self._release(replica, failed=False)
                return finish(503, {"error": "router deadline exceeded "
                                             f"({self.deadline_s:g}s)"})
            rounds += 1
            status, body, hedged, hedge_won, failed_urls, attempts = \
                self._dispatch_hedged(
                    replica, task, payload, remaining, exclude,
                    trace_id=trace_id, trace_sampled=sampled,
                    attempt_base=attempt_base,
                    prefer_version=prefer_version,
                    avoid_version=avoid_version)
            attempt_base += len(attempts)
            hedges_fired += 1 if hedged else 0
            winner = None
            for att in attempts:
                spans.append(self._attempt_span(att, t0))
                if att["won"]:
                    winner = att["attempt"]
                if hedged and not att["won"]:
                    # Hedge-loser waste (The Tail at Scale): in a round
                    # where a duplicate was racing, every non-winning
                    # attempt's latency was spent for an answer nobody
                    # used.
                    hedge_wasted_s += att["dur_s"]
            final = (status is not None
                     and status not in RETRYABLE_STATUSES)
            if final:
                # A final 4xx is the router WORKING: a definitive answer
                # relayed once (the same answer every replica would
                # give). Only 5xx-class outcomes — and the deadline/
                # exhausted-retry paths below — count into ``errors``,
                # the zero-tolerance "client saw a server failure" gate
                # (telemetry/report.py).
                return finish(status, body, ok=status < 500,
                              hedge_won=hedge_won,
                              failover=(failed_rounds > 0),
                              winning_attempt=winner)
            # Retryable failure: this replica (and any hedge target that
            # also failed) is out of the running for THIS request.
            failed_rounds += 1
            exclude.add(replica.url)
            exclude.update(failed_urls)
            policy = self.retry_policy
            if rounds >= policy.attempts:
                return finish(502, {
                    "error": f"request failed on {rounds} replica(s) "
                             f"(last status {status})"})
            backoff = policy.backoff_s(rounds - 1)
            if self._clock() + backoff >= deadline:
                return finish(503, {
                    "error": "router deadline exceeded during "
                             "failover backoff"})
            t_backoff = self._clock()
            self._sleep(backoff)
            spans.append(self._span("backoff", t0, t_backoff))

    def _span(self, name: str, t0: float, start_abs: float) -> dict:
        """One closed router span ending NOW, relative to the request
        start (start/dur in ms like serve_trace spans)."""
        now = self._clock()
        return {"name": name,
                "start_ms": round(max(0.0, (start_abs - t0)) * 1000.0, 3),
                "dur_ms": round(max(0.0, (now - start_abs)) * 1000.0, 3)}

    @staticmethod
    def _attempt_span(att: dict, t0: float) -> dict:
        span = {"name": "attempt",
                "start_ms": round(
                    max(0.0, (att["start"] - t0)) * 1000.0, 3),
                "dur_ms": round(max(0.0, att["dur_s"]) * 1000.0, 3),
                "attempt": att["attempt"],
                "replica": att["replica"],
                "outcome": att["outcome"],
                "hedge": att["hedge"]}
        if att["status"] is not None:
            span["status"] = att["status"]
        return span

    def _emit_trace(self, trace_id: str, task: str, status: int,
                    t0: float, spans: List[dict], hedges: int,
                    hedge_won: bool, hedge_wasted_s: float,
                    winning_attempt: Optional[int]) -> None:
        if self._emit_fn is None:
            return
        total_ms = (self._clock() - t0) * 1000.0
        # Round the total UP to the latest span end at the same
        # precision so the lint's per-span sub-interval bound survives
        # rounding (serve/tracing.py discipline).
        span_end = max((s["start_ms"] + s["dur_ms"] for s in spans),
                       default=0.0)
        record = {
            "kind": "router_trace", "tag": "router",
            "trace_id": trace_id, "task": task, "status": int(status),
            "total_ms": round(max(total_ms, span_end), 3),
            "sampled": True,
            "attempts": sum(1 for s in spans if s["name"] == "attempt"),
            "hedges": int(hedges),
            "hedge_won": bool(hedge_won),
            "hedge_wasted_ms": round(max(0.0, hedge_wasted_s) * 1000.0, 3),
            "spans": spans,
        }
        if winning_attempt is not None:
            record["winning_attempt"] = int(winning_attempt)
        try:
            self._emit_fn(record)
        except Exception:
            pass

    def _dispatch_hedged(self, primary: ReplicaState, task: str,
                         payload: dict, timeout_s: float, exclude: set,
                         trace_id: str, trace_sampled: bool,
                         attempt_base: int,
                         prefer_version: Optional[str] = None,
                         avoid_version: Optional[str] = None
                         ) -> Tuple[Optional[int], dict, bool, bool, set,
                                    List[dict]]:
        """One dispatch round, possibly hedged: (status, body, hedged,
        hedge_won, failed_urls, attempts). ``status`` None =
        transport-level failure; ``failed_urls`` is every replica that
        failed in this round (the caller's exclude list for the retry).
        ``attempts`` is one accounting dict per launched attempt —
        attempt index (numbered from ``attempt_base`` across the whole
        request), target replica, outcome, latency — closed out at the
        round's decision instant so a still-in-flight loser is measured
        by the time the race actually cost, not a latency nobody waited
        for. Each attempt propagates the request's trace context via
        ``X-Bert-Trace`` (when the transport takes headers)."""
        results: "queue.Queue" = queue.Queue()
        launched_urls = {primary.url}
        failed_urls: set = set()
        attempts: List[dict] = []

        def launch(rep: ReplicaState, is_hedge: bool) -> dict:
            att = {"attempt": attempt_base + len(attempts),
                   "replica": rep.url, "hedge": is_hedge,
                   "start": self._clock(), "end": None, "status": None,
                   "outcome": "pending", "won": False}
            attempts.append(att)
            threading.Thread(
                target=worker, args=(rep, is_hedge, att),
                name="router-hedge" if is_hedge else "router-dispatch",
                daemon=True).start()
            return att

        def worker(rep: ReplicaState, is_hedge: bool, att: dict) -> None:
            start = self._clock()
            try:
                if self._transport_headers:
                    status, body = self._transport(
                        rep.url, task, payload, timeout_s,
                        headers={TRACE_HEADER: format_trace_header(
                            trace_id, att["attempt"], trace_sampled)})
                else:
                    status, body = self._transport(
                        rep.url, task, payload, timeout_s)
            except Exception as exc:
                self._release(rep, failed=True)
                att["end"] = self._clock()
                att["outcome"] = "transport_error"
                results.put((None, {"error": f"{type(exc).__name__}: "
                                             f"{exc}"}, rep, is_hedge,
                             att))
                return
            retryable = status in RETRYABLE_STATUSES
            # A 503 is the replica ALIVE and telling us it is draining
            # or saturated — exclude it for this request, but only the
            # health scrape decides whether it stays routable.
            self._release(rep, failed=(retryable and status != 503))
            if not retryable:
                self.note_latency(self._clock() - start)
            att["status"] = status
            att["end"] = self._clock()
            att["outcome"] = "error" if retryable else "final"
            results.put((status, body, rep, is_hedge, att))

        def close_round(winner: Optional[dict]) -> None:
            """Stamp every attempt's decision-time latency and loser
            disposition (the hedge-waste basis)."""
            now = self._clock()
            for att in attempts:
                end = att["end"] if att["end"] is not None else now
                att["dur_s"] = max(0.0, end - att["start"])
                if att["outcome"] == "pending":
                    att["outcome"] = ("lost" if winner is not None
                                      else "abandoned")
                if winner is att:
                    att["won"] = True

        launch(primary, False)
        start = self._clock()
        deadline = start + timeout_s
        hedge_delay = self._hedge_delay_s()
        hedged = False
        hedge_tried = False
        failures = 0
        first_failure: Optional[Tuple[Optional[int], dict]] = None
        while True:
            now = self._clock()
            if now >= deadline:
                break
            wait = deadline - now
            if not hedge_tried and hedge_delay is not None:
                hedge_in = start + hedge_delay - now
                if hedge_in <= 0:
                    # The dispatch has outlived the configured
                    # percentile: fire ONE hedge on the next-best
                    # replica (if any remains) and race them. One
                    # attempt per round whether or not a target exists
                    # (hedge_tried) — ``hedged`` reports only a hedge
                    # actually LAUNCHED, and is counted by the caller at
                    # request completion (_observe), in the same lock
                    # acquisition as a potential hedge_win: counting the
                    # launch here let a window flush land between the
                    # two and emit hedge_wins > hedges, a
                    # schema-invalid record on a healthy run.
                    hedge_tried = True
                    hedge_rep = self._pick_hedge(
                        exclude | launched_urls,
                        prefer_version=prefer_version,
                        avoid_version=avoid_version)
                    if hedge_rep is not None:
                        hedged = True
                        launched_urls.add(hedge_rep.url)
                        launch(hedge_rep, True)
                    continue
                wait = min(wait, hedge_in)
            try:
                status, body, rep, is_hedge, att = results.get(
                    timeout=max(0.001, wait))
            except queue.Empty:
                continue
            if status is not None and status not in RETRYABLE_STATUSES:
                close_round(att)
                return status, body, hedged, is_hedge, failed_urls, \
                    attempts
            failures += 1
            failed_urls.add(rep.url)
            if first_failure is None:
                first_failure = (status, body)
            if failures >= len(attempts):
                # Everything launched has failed; a not-yet-fired hedge
                # would only duplicate a request the retry path is
                # about to place better.
                break
        close_round(None)
        if first_failure is not None:
            status, body = first_failure
        else:
            status, body = None, {
                "error": f"dispatch timed out after {timeout_s:.3f}s"}
            failed_urls.add(primary.url)
        return status, body, hedged, False, failed_urls, attempts

    def _pick_hedge(self, exclude: set,
                    prefer_version: Optional[str] = None,
                    avoid_version: Optional[str] = None
                    ) -> Optional[ReplicaState]:
        with self._lock:
            candidates = [rep for rep in self._replicas
                          if rep.eligible() and rep.url not in exclude]
            if not candidates:
                return None
            # Same soft version preference as _admit: a canary request's
            # hedge should race the SAME version (its latency evidence
            # must not mix versions), but a no-target hedge falls back
            # rather than not firing — tail rescue beats cohort purity.
            pool = candidates
            if prefer_version is not None or avoid_version is not None:
                if prefer_version is not None:
                    preferred = [rep for rep in candidates
                                 if rep.version == prefer_version]
                else:
                    preferred = [rep for rep in candidates
                                 if rep.version != avoid_version]
                if preferred:
                    pool = preferred
                elif self._split is not None:
                    self._split["fallbacks"] += 1
            chosen = min(pool,
                         key=lambda r: (r.load() + r.inflight,
                                        r.inflight, r.index))
            chosen.inflight += 1
            chosen.requests += 1
            self._version_requests[chosen.version or "unknown"] = \
                self._version_requests.get(chosen.version or "unknown",
                                           0) + 1
            return chosen

    # -- telemetry --------------------------------------------------------

    def _observe(self, ok: bool, shed: bool, t0: float, retries: int = 0,
                 hedges: int = 0, hedge_won: bool = False,
                 failover: bool = False,
                 hedge_wasted_ms: float = 0.0,
                 cohort: Optional[str] = None) -> None:
        latency_ms = (self._clock() - t0) * 1000.0
        with self._lock:
            # Cohort booking rides the same acquisition as the window
            # counters: the rollout controller's split_window() read can
            # never see a request half-booked.
            if cohort is not None and self._split is not None:
                acc = self._split.get(cohort)
                if acc is not None:
                    acc["requests"] += 1
                    if shed:
                        acc["sheds"] += 1
                    elif ok:
                        acc["ok"] += 1
                        acc["latency_ms"].append(latency_ms)
                    else:
                        acc["errors"] += 1
            for acc in (self._win, self._run):
                acc["requests"] += 1
                acc["retries"] += retries
                # Hedges launched by this request, folded in at the same
                # instant as its potential hedge_win so hedge_wins <=
                # hedges holds within EVERY window (schema invariant).
                acc["hedges"] += hedges
                # Hedge-loser waste rides the SAME acquisition: a window
                # flush can never see waste without the hedge that
                # produced it (the flush-race discipline; the
                # schema lint rejects wasted>0 with hedges==0).
                acc["hedge_wasted_ms"] += max(0.0, hedge_wasted_ms)
                if shed:
                    acc["sheds"] += 1
                elif ok:
                    acc["ok"] += 1
                    acc["latency_ms"].append(latency_ms)
                    if failover:
                        acc["failovers"] += 1
                        acc["failover_ms"].append(latency_ms)
                else:
                    acc["errors"] += 1
                if hedge_won:
                    acc["hedge_wins"] += 1
            due = self._win["requests"] >= self.window
        if due:
            self.flush_window()

    def _window_record_locked(self, acc: dict) -> dict:
        healthy = sum(1 for rep in self._replicas if rep.eligible())
        record = {
            "kind": "router_window", "tag": "router",
            "window_requests": acc["requests"],
            "ok": acc["ok"], "sheds": acc["sheds"],
            "errors": acc["errors"], "retries": acc["retries"],
            "hedges": acc["hedges"], "hedge_wins": acc["hedge_wins"],
            "hedge_wasted_ms": round(acc["hedge_wasted_ms"], 3),
            "failovers": acc["failovers"],
            "healthy_replicas": healthy,
            "replicas": len(self._replicas),
        }
        lat = sorted(acc["latency_ms"])
        if lat:
            record.update(
                latency_p50_ms=round(_pctl(lat, 0.50), 3),
                latency_p95_ms=round(_pctl(lat, 0.95), 3),
                latency_p99_ms=round(_pctl(lat, 0.99), 3))
        fo = sorted(acc["failover_ms"])
        if fo:
            record.update(
                failover_p50_ms=round(_pctl(fo, 0.50), 3),
                failover_p95_ms=round(_pctl(fo, 0.95), 3))
        return record

    def flush_window(self) -> Optional[dict]:
        """Emit (and return) the current router_window record; None when
        the window is empty."""
        with self._lock:
            if not self._win["requests"]:
                return None
            record = self._window_record_locked(self._win)
            self._win = self._zero_window()
        if self._emit_fn is not None:
            try:
                self._emit_fn(record)
            except Exception:
                pass
        return record

    def snapshot(self) -> dict:
        """Run-level rollup for the router's /statsz."""
        with self._lock:
            record = self._window_record_locked(self._run)
            record["kind"] = "router_summary"
            record.pop("window_requests")
            record["requests"] = self._run["requests"]
            record["replica_states"] = [{
                "url": rep.url, "healthy": rep.healthy,
                "draining": rep.draining, "queue_depth": rep.queue_depth,
                "unfinished": rep.unfinished,
                "inflight": rep.inflight, "requests": rep.requests,
                "version": rep.version,
            } for rep in self._replicas]
            record["version_requests"] = dict(self._version_requests)
            if self._split is not None:
                record["split"] = {
                    "task": self._split["task"],
                    "version": self._split["version"],
                    "share": self._split["share"],
                    "fallbacks": self._split["fallbacks"],
                    "canary_requests":
                        self._split["canary"]["requests"],
                    "control_requests":
                        self._split["control"]["requests"],
                }
        return record

    def metrics_text(self, prefix: str = "bert_router") -> str:
        """Prometheus text-exposition rendering of the run-level
        counters and per-replica health gauges — the same numbers
        /statsz serves as JSON, in the one format the fleet collector
        (telemetry/collector.py) scrapes everywhere. Rendered from
        :meth:`snapshot`, so the two surfaces cannot drift."""
        snap = self.snapshot()
        lines: List[str] = []

        def render(value) -> str:
            # Full precision, not %g: a run-level counter past ~1e6
            # would otherwise export rounded and drift from /statsz —
            # delta-computing scrapers would see it advance in jumps.
            v = float(value)
            return str(int(v)) if v.is_integer() else repr(v)

        def metric(name, value, kind, help_text=""):
            if value is None:
                return
            if help_text:
                lines.append(f"# HELP {prefix}_{name} {help_text}")
            lines.append(f"# TYPE {prefix}_{name} {kind}")
            lines.append(f"{prefix}_{name} {render(value)}")

        metric("requests_total", snap.get("requests"), "counter",
               "Requests routed (ok + sheds + errors).")
        for key in ("ok", "sheds", "errors", "retries", "hedges",
                    "hedge_wins", "failovers"):
            metric(f"{key}_total", snap.get(key), "counter")
        metric("hedge_wasted_ms_total", snap.get("hedge_wasted_ms"),
               "counter", "Hedge-loser latency burned (ms, run total).")
        metric("healthy_replicas", snap.get("healthy_replicas"), "gauge",
               "Replicas currently eligible for routing.")
        metric("replicas", snap.get("replicas"), "gauge")
        for key in ("latency_p50_ms", "latency_p95_ms", "latency_p99_ms",
                    "failover_p50_ms", "failover_p95_ms"):
            metric(key, snap.get(key), "gauge")
        name = f"{prefix}_replica_state"
        lines.append(f"# HELP {name} Per-replica router view "
                     "(healthy/draining/queue_depth/inflight).")
        lines.append(f"# TYPE {name} gauge")
        for i, rep in enumerate(snap.get("replica_states", ())):
            for field in ("healthy", "draining"):
                lines.append(
                    f'{name}{{replica="{i}",field="{field}"}} '
                    f"{1 if rep.get(field) else 0}")
            for field in ("queue_depth", "inflight"):
                lines.append(
                    f'{name}{{replica="{i}",field="{field}"}} '
                    f"{render(rep.get(field, 0))}")
            if rep.get("unfinished") is not None:
                lines.append(
                    f'{name}{{replica="{i}",field="unfinished"}} '
                    f"{render(rep['unfinished'])}")
        # Per-version routed counters (the rollout's traffic-shift
        # evidence): rendered from the SAME snapshot as /statsz, so the
        # two surfaces cannot drift. "unknown" = routed before the first
        # scrape carried a version.
        version_requests = snap.get("version_requests") or {}
        if version_requests:
            vname = f"{prefix}_version_requests"
            lines.append(f"# HELP {vname} Requests routed per serving "
                         "model version (run total).")
            lines.append(f"# TYPE {vname} counter")
            for version in sorted(version_requests):
                lines.append(
                    f'{vname}{{version="{version}"}} '
                    f"{render(version_requests[version])}")
        return "\n".join(lines) + "\n"

    def healthy_count(self) -> int:
        with self._lock:
            return sum(1 for rep in self._replicas if rep.eligible())

    def replica_count(self) -> int:
        with self._lock:
            return len(self._replicas)

    # -- elastic membership (serve/autoscaler.py, docs/serving.md
    # "Elastic fleet") ----------------------------------------------------

    def add_target(self, url: str) -> int:
        """Add a replica URL to the routing table. The new target
        enters UNHEALTHY (``ReplicaState``'s construction default) — no
        request routes to it until its first clean scrape proves the
        replica up, so a still-warming replica never absorbs traffic it
        cannot answer yet. Returns the target's router-local index
        (minted monotonically; never reused)."""
        url = url.rstrip("/")
        with self._lock:
            if any(rep.url == url for rep in self._replicas):
                raise ValueError(f"target already routed: {url}")
            index = self._next_target_index
            self._next_target_index += 1
            self._replicas.append(ReplicaState(url, index))
        return index

    def remove_target(self, url: str) -> bool:
        """Drop a replica URL from the routing table. The caller's
        contract (serve/autoscaler.py) is to remove only AFTER the
        supervisor confirms the drain — the replica answered its last
        in-flight request — so removal never strands a dispatch. A
        scrape probe already in flight writes back into the detached
        ``ReplicaState`` (harmless: no request thread can reach it
        through the table anymore). Refuses to empty the table (the
        constructor's own invariant). Returns whether the URL was
        routed at all."""
        url = url.rstrip("/")
        with self._lock:
            keep = [rep for rep in self._replicas if rep.url != url]
            if len(keep) == len(self._replicas):
                return False
            if not keep:
                raise ValueError("refusing to remove the last target")
            self._replicas = keep
        return True

    def split_active(self) -> bool:
        """Whether a canary traffic split is live — one of the
        autoscaler's hard scale-down holds (shrinking the fleet under
        an active cohort split would skew the rollout's per-window
        evidence mid-verdict)."""
        with self._lock:
            return self._split is not None

    def stop(self) -> None:
        """Stop the scrape thread, flush the partial window, and emit
        the run-level ``router_summary`` rollup (the exact-percentile
        record telemetry-report prefers over re-aggregating windows)."""
        self._stop_event.set()
        if self._scrape_thread is not None:
            self._scrape_thread.join(timeout=5.0)
            self._scrape_thread = None
        if self._heartbeat is not None:
            # Final flush so the file records the closing request count;
            # the scrape thread is joined, so this thread is the sole
            # owner of the beat now.
            with self._lock:
                routed = self._run["requests"]
            self._heartbeat.beat(routed)
        self.flush_window()
        with self._lock:
            routed_any = self._run["requests"] > 0
        if self._emit_fn is not None and routed_any:
            try:
                self._emit_fn(self.snapshot())
            except Exception:
                pass


# -- HTTP front end ---------------------------------------------------------
# Deliberately self-contained (not serve/http.py, which imports the
# engine stack and torch): the router process never imports torch.

MAX_BODY_BYTES = 1 << 20


class RouterHTTPServer(http.server.ThreadingHTTPServer):
    daemon_threads = True
    # The fleet front door: a client connect burst overflows the stdlib
    # listen backlog of 5 and the kernel RSTs the excess mid-handshake.
    request_queue_size = 128
    router: Router = None


def _make_router_handler():
    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # telemetry is the log
            pass

        def _reply(self, code: int, payload: dict,
                   headers: Optional[Dict[str, str]] = None) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            router = self.server.router
            if self.path == "/healthz":
                healthy = router.healthy_count()
                total = router.replica_count()
                ok = healthy > 0
                self._reply(200 if ok else 503, {
                    "status": "ok" if ok else "no_healthy_replica",
                    "healthy_replicas": healthy,
                    "replicas": total,
                })
            elif self.path == "/statsz":
                self._reply(200, router.snapshot())
            elif self.path == "/metricsz":
                # Prometheus text format (version 0.0.4), so the fleet
                # collector and standard scrapers consume ONE format
                # across replicas, trainers, and the router; /statsz
                # stays the human JSON surface.
                body = router.metrics_text().encode("utf-8")
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            router = self.server.router
            if not self.path.startswith("/v1/"):
                self._reply(404, {"error": f"no route {self.path}"})
                return
            task = self.path[len("/v1/"):].strip("/")
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_BODY_BYTES:
                    self._reply(413, {"error": "payload too large"})
                    return
                payload = json.loads(
                    self.rfile.read(length).decode("utf-8") or "{}")
                if not isinstance(payload, dict):
                    raise ValueError("payload must be a JSON object")
            except ValueError as exc:
                self._reply(400, {"error": f"bad JSON payload: {exc}"})
                return
            status, body, headers = router.handle(task, payload)
            self._reply(status, body, headers)

    return Handler


def make_router_server(router: Router, host: str = "127.0.0.1",
                       port: int = 8100) -> RouterHTTPServer:
    """Build (but do not start) the router's HTTP server; ``port=0``
    binds an ephemeral port (tests read ``server.server_address``)."""
    server = RouterHTTPServer((host, port), _make_router_handler())
    server.router = router
    return server
