"""Signal-driven autoscaler: elastic fleet capacity with hysteresis,
surge protection, and graceful scale-down (docs/serving.md "Elastic
fleet", docs/fault_tolerance.md "Scale-down drain contract") — a copy
of the JAX package's ``serve/autoscaler.py``, kept decision for decision
(``tests/test_torch_fleet.py`` holds the two to the same ``scale_event``
records).

The supervisor and router make the fleet *resilient* (restarts,
failover) and continuous batching makes it *fast*, but without this
loop capacity stays fixed at launch: a traffic surge ended in brownout sheds, and a quiet
fleet burned replicas it did not need. The missing piece is a CONTROL
LOOP over the signals the fleet already exports — the replicas'
queue-wait share and error-budget burn (serve/tracing.py), the
``bert_serve_unfinished`` load gauge the router scrapes, and the
router's own shed/error counters — deciding ``scale_up`` /
``scale_down`` / ``hold`` each tick (Verma et al. 2015, Borg; Dean &
Barroso 2013 for why a warm start — a new replica finding its CUDA
kernel libraries already built in the shared ``--compile_cache_dir``,
``compiles_cold == 0`` — is the precondition that makes REACTIVE scaling
viable at all).

Three disciplines keep the loop from thrashing the fleet it manages:

* **window evidence, not instantaneous readings** — a decision needs
  ``red_windows_to_scale_up`` consecutive overloaded windows (or
  ``green_windows_to_scale_down`` consecutive idle ones), the same
  consecutive-green discipline the rollout controller uses
  (serve/rollout.py). A red window additionally needs
  ``min_window_requests`` of traffic behind it (or an actual shed) —
  one noisy sample over a thin window is not a surge;
* **separate up/down cooldowns** — after ANY scaling action, another
  ``scale_up`` must wait ``up_cooldown_s`` and another ``scale_down``
  must wait ``down_cooldown_s`` (down is the slower, more cautious
  direction). A direction FLIP inside the cooldown window is therefore
  structurally impossible — which is exactly why the telemetry-report
  gate "autoscaler thrash" is zero-tolerance: the controller counts
  what cannot happen so the claim is falsifiable, the torn-serves
  pattern;
* **hard scale-down holds** — never shrink while any replica is in
  crash backoff or restarting (a SIGKILLed replica's owed respawn is
  not spare capacity), never while a previous drain is still in flight,
  never below ``min_replicas`` healthy, and never while a canary
  traffic split is active (serve/rollout.py owns the fleet's shape
  mid-rollout). Each hold names itself in the emitted record's
  ``reason``.

Scale-up goes through ``Supervisor.add_replica`` (fresh port + output
dir + never-reused index from a :class:`ReplicaTemplate`) and
``Router.add_target`` (the new target enters unhealthy until its first
clean scrape). Scale-down drains through the existing SIGTERM → rc-75
preemption contract (``Supervisor.drain_replica``: reap WITHOUT
respawn) and removes the router target only after the supervisor
confirms the drain — zero stranded requests, proven end to end by
``tools/chaos_serve.py --surge``.

Every tick's verdict is a schema-v1 ``scale_event`` record carrying the
decision, the triggering signal values, the replica count before/after,
and the cooldown/hold reason; the cross-record lint
(telemetry/schema.py) reconstructs fleet membership from the event
stream alone, so a decision the artifact cannot explain is a lint
failure, not a mystery.

This module is **stdlib-only and dual-loadable** like supervisor/router:
imported normally it is part of the serve package; loaded by FILE PATH
(tools/_bootstrap.py) it pulls its dependencies the same way, so the
torch-free chaos parent never executes the ``serve`` package
``__init__`` chain.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, List, Optional


def _load_pkg_module(subpkg: str, modname: str):
    """Import a stdlib-only package sibling both ways: through the
    package when this module was imported normally, by file path when
    this module was itself loaded by path (the package ``__init__``
    chain imports torch — the property tools/chaos_serve.py needs)."""
    if __package__:
        import importlib

        return importlib.import_module(
            f"bert_pytorch_tpu_torch.{subpkg}.{modname}")
    import importlib.util

    alias = f"_torchfleet_{subpkg}_{modname}"
    module = sys.modules.get(alias)
    if module is not None:
        return module
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), subpkg, f"{modname}.py")
    spec = importlib.util.spec_from_file_location(alias, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return module


_schema = _load_pkg_module("telemetry", "schema")
_supervisor = _load_pkg_module("serve", "supervisor")

# The decision vocabulary is pinned in telemetry/schema.py (the
# registry.py pattern): runtime and offline lint cannot drift.
SCALE_UP, SCALE_DOWN, HOLD = _schema.SCALE_DECISIONS

# Replica lifecycle states (serve/supervisor.py) the capacity/hold
# classification reads from status() rows.
_STARTING = _supervisor.STARTING
_RUNNING = _supervisor.RUNNING
_BACKOFF = _supervisor.BACKOFF
_FAILED = _supervisor.FAILED
_STOPPED = _supervisor.STOPPED


class AutoscalerError(ValueError):
    """Bad autoscaler configuration or an illegal call."""


def _is_active(st: dict) -> bool:
    """Whether a ``Supervisor.status()`` row counts as fleet capacity:
    not decommissioned (draining) and not given up on. BACKOFF/STARTING
    still count — a SIGKILLed replica's owed respawn is the SAME
    capacity, not new capacity (double-counting it is exactly the drift
    the membership chain lint forbids)."""
    return (not st.get("draining")
            and st.get("state") not in (_STOPPED, _FAILED))


class ElasticFleet:
    """Binds a live ``Supervisor`` + ``Router`` + ``ReplicaTemplate``
    into the actuation surface :class:`AutoscalerController` drives.

    Thread-safety rides the bound objects' own locks; the adapter's
    only state of its own is the pending-drain list (a drain is
    two-phase: SIGTERM now, router-target removal only after the
    supervisor confirms the exit), guarded by ``_lock``.
    """

    def __init__(self, supervisor, router, template,
                 alloc_port: Optional[Callable[[], int]] = None):
        self._supervisor = supervisor
        self._router = router
        self._template = template
        self._alloc_port = alloc_port
        self._lock = threading.Lock()
        self._pending_drains: List[dict] = []  # [{"replica", "url"}]

    # -- observation ------------------------------------------------------

    def status(self) -> List[dict]:
        return self._supervisor.status()

    def split_active(self) -> bool:
        return self._router.split_active()

    def draining(self) -> bool:
        """A drain is in flight until the router target is removed."""
        with self._lock:
            if self._pending_drains:
                return True
        return any(st.get("draining") and st.get("state") != _STOPPED
                   for st in self._supervisor.status())

    # -- actuation --------------------------------------------------------

    def scale_up(self) -> dict:
        """Grow by one: supervisor spawns from the template (fresh
        port/dir/index), then the router learns the target — which
        enters unhealthy until its first clean scrape, so the warming
        replica takes no traffic."""
        spec = self._supervisor.add_replica(
            self._template,
            port=self._alloc_port() if self._alloc_port else None)
        self._router.add_target(spec.url)
        return {"replica": spec.index, "url": spec.url,
                "port": spec.port}

    def begin_drain(self) -> Optional[dict]:
        """Pick the scale-down victim — the HIGHEST-index active
        replica, so elastically added capacity leaves first and the
        seed fleet stays — and start its SIGTERM drain. The router
        keeps routing to it until the supervisor confirms the exit
        (:meth:`reap_drained`); the replica's own draining gauge flips
        its router health on the next scrape, so new traffic stops
        while in-flight work finishes."""
        candidates = [st for st in self._supervisor.status()
                      if _is_active(st)]
        if not candidates:
            return None
        victim = max(candidates, key=lambda st: st["replica"])
        self._supervisor.drain_replica(victim["replica"])
        item = {"replica": victim["replica"], "url": victim["url"]}
        with self._lock:
            self._pending_drains.append(item)
        return dict(item)

    def reap_drained(self) -> List[dict]:
        """Remove the router target of every drain the supervisor has
        confirmed (state STOPPED). Called at the top of each controller
        tick — removal strictly AFTER the replica answered its last
        in-flight request."""
        states = {st["replica"]: st for st in self._supervisor.status()}
        with self._lock:
            pending = list(self._pending_drains)
        done = []
        for item in pending:
            st = states.get(item["replica"])
            if st is not None and st.get("state") == _STOPPED:
                self._router.remove_target(item["url"])
                with self._lock:
                    if item in self._pending_drains:
                        self._pending_drains.remove(item)
                done.append(item)
        return done


class RouterSignals:
    """Per-tick signal windows from a live :class:`Router` (and,
    optionally, the replicas' own ``/statsz``).

    Each call returns ONE observation window: deltas of the router's
    run-level outcome counters (requests/errors/sheds) since the
    previous call, the summed ``bert_serve_unfinished`` load gauge from
    the router's scrape table, and — when ``probe`` is wired — the
    worst per-replica ``queue_wait_share`` / ``slo_budget_burn`` from
    the tracing rollup (serve/tracing.py via ``/statsz`` ``phases``).
    Max over replicas on purpose: one overloaded replica is the surge
    signal; averaging it away is how brownouts sneak up.

    Single-caller by design (the controller's tick loop): the
    delta baseline is the only mutable state.
    """

    def __init__(self, router,
                 probe: Optional[Callable[[str], Optional[dict]]] = None):
        self._router = router
        self._probe = probe
        self._last = {"requests": 0, "errors": 0, "sheds": 0}

    def __call__(self) -> dict:
        snap = self._router.snapshot()
        reps = snap.get("replica_states") or []
        sig = {
            "window_requests": int(snap.get("requests", 0)
                                   - self._last["requests"]),
            "window_errors": int(snap.get("errors", 0)
                                 - self._last["errors"]),
            "window_sheds": int(snap.get("sheds", 0)
                                - self._last["sheds"]),
            "unfinished": sum(int(r.get("unfinished") or 0)
                              for r in reps),
        }
        self._last = {key: int(snap.get(key, 0))
                      for key in ("requests", "errors", "sheds")}
        if self._probe is not None:
            shares, burns = [], []
            for r in reps:
                try:
                    stats = self._probe(r["url"]) or {}
                except Exception:
                    continue
                phases = stats.get("phases") or {}
                if phases.get("queue_wait_share") is not None:
                    shares.append(float(phases["queue_wait_share"]))
                if phases.get("slo_budget_burn") is not None:
                    burns.append(float(phases["slo_budget_burn"]))
            if shares:
                sig["queue_wait_share"] = max(shares)
            if burns:
                sig["budget_burn"] = max(burns)
        return sig


class AutoscalerController:
    """The control loop: classify each signal window red (overloaded) /
    green (idle) / neutral, accumulate consecutive-window evidence, and
    scale within the ``[min_replicas, max_replicas]`` band under the
    cooldowns and hard holds documented in the module docstring.

    Collaborators are injectable for deterministic tests: ``fleet`` is
    anything with the :class:`ElasticFleet` surface (status /
    split_active / draining / scale_up / begin_drain / reap_drained),
    ``signals`` is a zero-arg callable returning one window's signal
    dict, ``clock`` a monotonic float. :meth:`tick` is public — the
    fake-clock tests drive passes themselves; :meth:`start` runs the
    production loop thread.

    All decision state lives under ``_lock``: the loop thread mutates it while
    status() readers snapshot it.
    """

    def __init__(
        self,
        fleet,
        signals: Callable[[], dict],
        min_replicas: int = 1,
        max_replicas: int = 4,
        red_windows_to_scale_up: int = 2,
        green_windows_to_scale_down: int = 4,
        up_cooldown_s: float = 5.0,
        down_cooldown_s: float = 20.0,
        min_window_requests: int = 8,
        queue_wait_share_high: float = 0.25,
        queue_wait_share_low: float = 0.05,
        budget_burn_high: float = 1.0,
        budget_burn_low: float = 0.25,
        unfinished_high_per_replica: float = 8.0,
        unfinished_low_per_replica: float = 1.0,
        emit: Optional[Callable[[dict], None]] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if not 1 <= int(min_replicas) <= int(max_replicas):
            raise AutoscalerError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"[{min_replicas}, {max_replicas}]")
        if int(red_windows_to_scale_up) < 1 \
                or int(green_windows_to_scale_down) < 1:
            raise AutoscalerError("evidence windows must be >= 1")
        if float(up_cooldown_s) < 0 or float(down_cooldown_s) < 0:
            raise AutoscalerError("cooldowns must be >= 0")
        for low, high, what in (
                (queue_wait_share_low, queue_wait_share_high,
                 "queue_wait_share"),
                (budget_burn_low, budget_burn_high, "budget_burn"),
                (unfinished_low_per_replica, unfinished_high_per_replica,
                 "unfinished_per_replica")):
            if not 0 <= float(low) < float(high):
                raise AutoscalerError(
                    f"need 0 <= {what}_low < {what}_high, got "
                    f"[{low}, {high}]")
        self.fleet = fleet
        self.signals = signals
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.red_windows_to_scale_up = int(red_windows_to_scale_up)
        self.green_windows_to_scale_down = int(green_windows_to_scale_down)
        self.up_cooldown_s = float(up_cooldown_s)
        self.down_cooldown_s = float(down_cooldown_s)
        self.min_window_requests = int(min_window_requests)
        self.queue_wait_share_high = float(queue_wait_share_high)
        self.queue_wait_share_low = float(queue_wait_share_low)
        self.budget_burn_high = float(budget_burn_high)
        self.budget_burn_low = float(budget_burn_low)
        self.unfinished_high_per_replica = float(
            unfinished_high_per_replica)
        self.unfinished_low_per_replica = float(unfinished_low_per_replica)
        self._emit_fn = emit
        self._clock = clock
        self._sleep = sleep
        # Decision state: consecutive-window evidence, cooldown
        # bookkeeping, the membership chain tail, and the impossibility
        # counter — all under _lock (the loop thread mutates while
        # status() readers snapshot).
        self._lock = threading.Lock()
        self._reds = 0
        self._greens = 0
        self._ticks = 0
        self._scale_ups = 0
        self._scale_downs = 0
        self._last_scale_at: Optional[float] = None
        self._last_direction: Optional[str] = None
        self._last_after: Optional[int] = None
        self._last_emitted: Optional[tuple] = None
        # Structurally impossible under the cooldown rule — counted
        # precisely so the zero-tolerance "autoscaler thrash" claim is
        # falsifiable (the torn-serves pattern).
        self._thrash = 0
        self._last_error: Optional[str] = None
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- window classification -------------------------------------------

    def _classify(self, sig: dict, capacity: int):
        """(red, green, why): red = overload evidence, green = idle
        evidence, neither = neutral (resets both streaks)."""
        reqs = int(sig.get("window_requests", 0) or 0)
        sheds = int(sig.get("window_sheds", 0) or 0)
        share = sig.get("queue_wait_share")
        burn = sig.get("budget_burn")
        unfinished = sig.get("unfinished")
        per_rep = (float(unfinished) / max(1, capacity)
                   if unfinished is not None else None)
        why = []
        if sheds > 0:
            why.append(f"sheds={sheds}")
        if share is not None \
                and float(share) >= self.queue_wait_share_high:
            why.append(f"queue_wait_share={float(share):.3f}")
        if burn is not None and float(burn) >= self.budget_burn_high:
            why.append(f"budget_burn={float(burn):.3f}")
        if per_rep is not None \
                and per_rep >= self.unfinished_high_per_replica:
            why.append(f"unfinished_per_replica={per_rep:.1f}")
        # Evidence floor: a hot reading over a thin window is noise —
        # unless the fleet actually SHED, which is its own evidence.
        red = bool(why) and (sheds > 0
                             or reqs >= self.min_window_requests)
        green = (not why and sheds == 0
                 and (share is None
                      or float(share) <= self.queue_wait_share_low)
                 and (burn is None
                      or float(burn) <= self.budget_burn_low)
                 and (per_rep is None
                      or per_rep <= self.unfinished_low_per_replica))
        return red, green, why

    def _cooldown_remaining(self, now: float, direction: str) -> float:
        if self._last_scale_at is None:
            return 0.0
        cool = (self.up_cooldown_s if direction == SCALE_UP
                else self.down_cooldown_s)
        return max(0.0, cool - (now - self._last_scale_at))

    # -- the control pass (public for fake-clock tests) -------------------

    def tick(self) -> dict:
        """One control pass: finish confirmed drains, read one signal
        window, classify, decide, actuate, emit. Returns the
        scale_event record (also emitted, deduplicated for holds)."""
        self.fleet.reap_drained()
        now = self._clock()
        sig = dict(self.signals() or {})
        status = self.fleet.status()
        active = [st for st in status if _is_active(st)]
        capacity = len(active)
        healthy = sum(1 for st in active if st.get("state") == _RUNNING)
        restarting = sum(1 for st in active
                         if st.get("state") in (_BACKOFF, _STARTING))
        draining = self.fleet.draining()
        split = self.fleet.split_active()
        red, green, why = self._classify(sig, capacity)

        with self._lock:
            self._ticks += 1
            if red:
                self._reds += 1
                self._greens = 0
            elif green:
                self._greens += 1
                self._reds = 0
            else:
                self._reds = 0
                self._greens = 0
            decision, reason = HOLD, "hold:evidence"
            if self._reds >= self.red_windows_to_scale_up:
                if capacity >= self.max_replicas:
                    reason = "hold:band_max"
                elif self._cooldown_remaining(now, SCALE_UP) > 0:
                    reason = "hold:up_cooldown"
                else:
                    decision = SCALE_UP
                    reason = "red_windows:" + ",".join(why)
            elif self._greens >= self.green_windows_to_scale_down:
                # Hard holds, in a fixed order: the reason names the
                # FIRST thing blocking the shrink.
                if capacity <= self.min_replicas:
                    reason = "hold:band_min"
                elif split:
                    reason = "hold:canary_split"
                elif draining:
                    reason = "hold:draining"
                elif restarting:
                    reason = "hold:restarting"
                elif healthy - 1 < self.min_replicas:
                    reason = "hold:min_healthy"
                elif self._cooldown_remaining(now, SCALE_DOWN) > 0:
                    reason = "hold:down_cooldown"
                else:
                    decision, reason = SCALE_DOWN, "green_windows"
            reds, greens = self._reds, self._greens
            since = (None if self._last_scale_at is None
                     else now - self._last_scale_at)

        # Actuate OUTSIDE the lock: spawning/draining does real I/O.
        detail: dict = {}
        if decision == SCALE_UP:
            try:
                detail = self.fleet.scale_up() or {}
            except Exception as exc:
                decision = HOLD
                reason = f"hold:scale_up_failed:{type(exc).__name__}"
                with self._lock:
                    self._last_error = f"{type(exc).__name__}: {exc}"
        elif decision == SCALE_DOWN:
            try:
                detail = self.fleet.begin_drain() or {}
            except Exception as exc:
                detail = {}
                with self._lock:
                    self._last_error = f"{type(exc).__name__}: {exc}"
            if not detail:
                decision, reason = HOLD, "hold:no_candidate"

        with self._lock:
            delta = {SCALE_UP: 1, SCALE_DOWN: -1}.get(decision, 0)
            before = capacity
            after = capacity + delta
            # Exogenous membership drift since the last EMITTED event
            # (a replica gave up, an operator intervened): stamped so
            # the offline lint can still reconstruct the chain.
            exogenous = (0 if self._last_after is None
                         else before - self._last_after)
            if decision == SCALE_UP:
                self._scale_ups += 1
                self._reds = 0
            elif decision == SCALE_DOWN:
                self._scale_downs += 1
                self._greens = 0
            if decision in (SCALE_UP, SCALE_DOWN):
                if (self._last_direction is not None
                        and decision != self._last_direction
                        and since is not None
                        and since < self._cooldown_for(decision)):
                    self._thrash += 1
                self._last_scale_at = now
                self._last_direction = decision
            record = {
                "kind": "scale_event", "tag": "autoscale",
                "decision": decision, "reason": reason,
                "replicas_before": before, "replicas_after": after,
                "exogenous": exogenous,
                "healthy": healthy,
                "reds": reds, "greens": greens,
                "window_requests": int(sig.get("window_requests", 0) or 0),
                "window_errors": int(sig.get("window_errors", 0) or 0),
                "window_sheds": int(sig.get("window_sheds", 0) or 0),
                "cooldown_s": self._cooldown_for(decision),
            }
            for key in ("queue_wait_share", "budget_burn", "unfinished"):
                if sig.get(key) is not None:
                    record[key] = sig[key]
            if since is not None:
                record["since_last_scale_s"] = round(since, 3)
            if detail.get("replica") is not None:
                record["replica"] = int(detail["replica"])
            # Hold-spam control: a hold repeating the previous hold's
            # reason with no membership movement adds nothing — emit
            # scaling actions always, holds only when something changed.
            dedup_key = (decision, reason, before, after, exogenous)
            emit_it = (decision != HOLD
                       or dedup_key != self._last_emitted)
            if emit_it:
                self._last_emitted = dedup_key
                self._last_after = after
        if emit_it:
            self._emit(record)
        return record

    def _cooldown_for(self, decision: str) -> float:
        """The cooldown the record is accountable to: a scale_down (or
        a hold) answers to the stricter down cooldown, a scale_up to
        the up cooldown — the offline thrash lint compares
        ``since_last_scale_s`` against exactly this number."""
        return (self.up_cooldown_s if decision == SCALE_UP
                else self.down_cooldown_s)

    def _emit(self, record: dict) -> None:
        if self._emit_fn is None:
            return
        try:
            self._emit_fn(record)
        except Exception:
            pass  # observability must never take the control loop down

    # -- lifecycle --------------------------------------------------------

    def start(self, interval_s: float = 1.0) -> None:
        """Run the control loop on its own daemon thread."""
        if self._thread is not None:
            raise AutoscalerError("controller already started")
        self._stop_event.clear()
        self._thread = threading.Thread(
            target=self._loop, args=(float(interval_s),),
            name="fleet-autoscaler", daemon=True)
        self._thread.start()

    def _loop(self, interval_s: float) -> None:
        while not self._stop_event.is_set():
            try:
                self.tick()
            except Exception as exc:
                # The loop survives a transient actuation/scrape error;
                # the error is surfaced in status() for the harness.
                with self._lock:
                    self._last_error = f"{type(exc).__name__}: {exc}"
            self._sleep(interval_s)

    def stop(self) -> None:
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def status(self) -> dict:
        """Controller snapshot under the lock — what the chaos harness
        and tests assert on."""
        with self._lock:
            return {
                "ticks": self._ticks,
                "reds": self._reds,
                "greens": self._greens,
                "scale_ups": self._scale_ups,
                "scale_downs": self._scale_downs,
                "thrash": self._thrash,
                "replicas": self._last_after,
                "last_error": self._last_error,
            }
