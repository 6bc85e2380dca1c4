"""SLO-gated canary rollout controller (docs/serving.md "Model
registry & canary rollouts") — a copy of the JAX package's
``serve/rollout.py`` (``tests/test_torch_fleet.py`` holds the two to the
same ``rollout_window`` records).

One :class:`RolloutController` drives one version of one task from
``staged`` to ``live`` through a staircase of traffic shares
(default 1% -> 50% -> 100%) using the router's deterministic
request-hash split (serve/router.py ``set_split``). The loop per
observation window:

1. read the router's per-cohort outcome window
   (``Router.split_window()`` — requests/ok/errors/sheds + latency
   percentiles for canary and control separately);
2. once the canary cohort has seen at least ``min_window_requests``,
   compute the SLO verdict: error share within the error budget, p95
   within the latency SLO (when configured), and ZERO torn-model
   serves (the zero-tolerance structural invariant —
   serve/engine.py's atomic flip makes it structurally impossible, and
   the rollout still checks the counter because "structurally
   impossible" is a claim telemetry must be able to falsify);
3. act: **hold** (not enough evidence, or green but not yet enough
   consecutive green windows), **advance** (enough consecutive greens
   at this stage -> widen the split to the next share), **promote**
   (greens at the final 100% stage -> registry promote, swap every
   remaining replica via ``on_promote``, clear the split), or
   **rollback** (ANY breach -> clear the split instantly so canary
   traffic snaps back to the old version, ``on_rollback``, registry
   canary -> staged with the breach reason).

Every observation emits one schema-v1 ``rollout_window`` record
(telemetry/schema.py): the report's "rollout canary SLO" and "rollout
torn-model serves" gates read them, and the schema's cross-record lint
holds canary_share monotone per (task, version) unless a rollback
intervenes — the emitted share is the share DURING the observed
window, so an advance in the same record keeps the sequence legal.

Rollback is deliberately instant and unconditional on first breach: a
canary exists to bound blast radius, and the cheapest safe action is
always "old version everywhere, human decides later". There is no
re-try staircase here — a rolled-back controller is terminal; publish
a fixed version and run a new rollout.

Stdlib-only and dual-loadable by file path like the router and
supervisor (tools/chaos_serve.py drives rollouts from a torch-free
parent process).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Sequence


class RolloutError(RuntimeError):
    """Misuse of the rollout state machine (started twice, observed
    after a terminal action, bad stage list)."""


class RolloutController:
    """Drive one canary rollout; all mutable stage state lives under
    ``_lock`` (observe() may be called from a scheduler thread while
    status() is read from an HTTP handler).

    Parameters
    ----------
    router:
        The serve/router.py Router (or any object with ``set_split`` /
        ``clear_split`` / ``split_window``).
    registry:
        serve/registry.py ModelRegistry holding ``version``.
    task, version:
        What is being rolled out.
    stages:
        Ascending traffic shares, last one 1.0 (full shift).
    min_window_requests:
        Canary-cohort requests an observation window must contain
        before its verdict counts — a 1% canary at low traffic must
        not advance on three requests' worth of evidence.
    green_windows_to_advance:
        Consecutive green verdicts required per stage.
    slo_p95_ms:
        Canary p95 latency bound; None disables the latency gate
        (error budget still applies).
    error_budget:
        Max tolerated canary error share per window (errors /
        requests), e.g. 0.01.
    emit:
        Telemetry sink for ``rollout_window`` records.
    on_promote / on_rollback:
        Fleet-side effects (swap remaining replicas / re-swap canary
        replicas back). Called OUTSIDE the controller lock, after the
        router split has already been updated — the router never routes
        on a stale split while the fleet converges.
    scrape_torn:
        Zero-arg callable returning the fleet's current torn-serve
        count (sum of replica /statsz ``torn_serves``); None -> 0.
    """

    def __init__(
        self,
        router,
        registry,
        task: str,
        version: str,
        stages: Sequence[float] = (0.01, 0.50, 1.0),
        min_window_requests: int = 20,
        green_windows_to_advance: int = 2,
        slo_p95_ms: Optional[float] = None,
        error_budget: float = 0.01,
        emit: Optional[Callable[[dict], None]] = None,
        on_promote: Optional[Callable[[], None]] = None,
        on_rollback: Optional[Callable[[str], None]] = None,
        scrape_torn: Optional[Callable[[], int]] = None,
        clock: Callable[[], float] = time.time,
    ):
        stages = tuple(float(s) for s in stages)
        if not stages or any(not 0.0 < s <= 1.0 for s in stages):
            raise RolloutError(
                f"stages must be shares in (0, 1], got {stages}")
        if list(stages) != sorted(stages):
            raise RolloutError(
                f"stages must ascend (the monotone-share contract "
                f"the schema lint enforces), got {stages}")
        if stages[-1] != 1.0:
            raise RolloutError(
                f"final stage must be 1.0 (full shift), got {stages[-1]}")
        if not 0.0 <= float(error_budget) <= 1.0:
            raise RolloutError(
                f"error_budget must be in [0, 1], got {error_budget}")
        self.router = router
        self.registry = registry
        self.task = str(task)
        self.version = str(version)
        self.stages = stages
        self.min_window_requests = max(1, int(min_window_requests))
        self.green_windows_to_advance = max(
            1, int(green_windows_to_advance))
        self.slo_p95_ms = (float(slo_p95_ms)
                           if slo_p95_ms is not None else None)
        self.error_budget = float(error_budget)
        self._emit_fn = emit
        self._on_promote = on_promote
        self._on_rollback = on_rollback
        self._scrape_torn = scrape_torn
        self._clock = clock
        # Stage state: _stage indexes ``stages``; _greens counts
        # consecutive green windows AT this stage; _state is
        # "idle" | "canary" | "promoted" | "rolled_back" (terminal two).
        self._lock = threading.Lock()
        self._stage = 0
        self._greens = 0
        self._state = "idle"
        self._windows = 0

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        """Begin the rollout: registry staged -> canary, install the
        first-stage split. The registry transition runs FIRST — if the
        version is not publishable (bad state, failed verify), no
        traffic ever shifts."""
        with self._lock:
            if self._state != "idle":
                raise RolloutError(
                    f"rollout already {self._state}; controllers are "
                    "single-use")
            self._state = "canary"
        self.registry.begin_canary(self.version)
        self.router.set_split(self.task, self.version, self.stages[0])

    def status(self) -> dict:
        with self._lock:
            return {
                "task": self.task, "version": self.version,
                "state": self._state, "stage": self._stage,
                "share": self.stages[min(self._stage,
                                         len(self.stages) - 1)],
                "greens": self._greens, "windows": self._windows,
            }

    # -- the observation loop ---------------------------------------------

    def observe(self, window: Optional[dict] = None) -> dict:
        """Evaluate one observation window and act on it; returns the
        emitted ``rollout_window`` record (with the action taken).
        ``window`` overrides the router read for tests; normally the
        controller pulls-and-resets ``router.split_window()``."""
        with self._lock:
            if self._state != "canary":
                raise RolloutError(
                    f"cannot observe a rollout in state {self._state}")
            stage = self._stage
            share = self.stages[stage]
        if window is None:
            window = self.router.split_window(reset=True)
        if window is None:
            raise RolloutError(
                "router has no active split (cleared externally?)")
        canary = window.get("canary") or {}
        requests = int(canary.get("requests", 0))
        ok = int(canary.get("ok", 0))
        errors = int(canary.get("errors", 0))
        torn = int(self._scrape_torn()) if self._scrape_torn else 0

        # -- verdict -------------------------------------------------------
        enough = requests >= self.min_window_requests
        breach_reason: Optional[str] = None
        if torn > 0:
            # Zero tolerance, checked before anything else and even on
            # thin evidence: one torn serve means the atomic-flip
            # invariant broke, and no amount of green latency excuses it.
            breach_reason = (f"torn-model serves detected ({torn}); "
                            "atomic-flip invariant violated")
        elif enough:
            error_share = errors / requests if requests else 0.0
            if error_share > self.error_budget:
                breach_reason = (
                    f"canary error share {error_share:.4f} exceeds "
                    f"budget {self.error_budget:.4f} "
                    f"({errors}/{requests})")
            elif (self.slo_p95_ms is not None
                  and canary.get("latency_p95_ms") is not None
                  and float(canary["latency_p95_ms"]) > self.slo_p95_ms):
                breach_reason = (
                    f"canary p95 {canary['latency_p95_ms']:.1f}ms "
                    f"exceeds SLO {self.slo_p95_ms:.1f}ms")
        slo_ok = breach_reason is None

        # -- act -----------------------------------------------------------
        action = "hold"
        if breach_reason is not None:
            action = "rollback"
        elif enough:
            with self._lock:
                self._greens += 1
                greens = self._greens
            if greens >= self.green_windows_to_advance:
                action = ("promote" if stage == len(self.stages) - 1
                          else "advance")

        if action == "rollback":
            # Order matters: clear the split FIRST so the very next
            # request routes away from the canary, then unwind the
            # fleet, then record the registry transition (which carries
            # the reason for the audit trail).
            self.router.clear_split()
            with self._lock:
                self._state = "rolled_back"
            if self._on_rollback is not None:
                self._on_rollback(breach_reason)
            self.registry.rollback(self.version, breach_reason)
        elif action == "advance":
            with self._lock:
                self._stage = stage + 1
                self._greens = 0
                next_share = self.stages[self._stage]
            self.router.set_split(self.task, self.version, next_share)
        elif action == "promote":
            # Registry first (live is the source of truth), then the
            # fleet converges (remaining replicas swap), then the split
            # drops — while replicas are still converging the split
            # keeps steering traffic to already-swapped replicas.
            self.registry.promote(self.version)
            with self._lock:
                self._state = "promoted"
            if self._on_promote is not None:
                self._on_promote()
            self.router.clear_split()

        record = self._window_record(
            stage=stage, share=share, window=window, requests=requests,
            ok=ok, errors=errors, slo_ok=slo_ok, action=action,
            reason=breach_reason, torn=torn)
        with self._lock:
            self._windows += 1
        self._emit(record)
        return record

    # -- record building --------------------------------------------------

    def _window_record(self, stage: int, share: float, window: dict,
                       requests: int, ok: int, errors: int,
                       slo_ok: bool, action: str,
                       reason: Optional[str], torn: int) -> dict:
        canary = window.get("canary") or {}
        record = {
            "kind": "rollout_window", "tag": "rollout",
            "task": self.task, "version": self.version,
            "stage": int(stage),
            # The share DURING the observed window (pre-advance): the
            # schema's cross-record lint holds shares monotone per
            # (task, version), and emitting the next stage's share here
            # would double-report the advance.
            "canary_share": float(share),
            "window_requests": int(requests),
            "ok": int(ok), "errors": int(errors),
            "slo_ok": bool(slo_ok), "action": str(action),
            "torn_serves": int(torn),
        }
        if requests:
            record["budget_burn"] = round(
                (errors / requests) / self.error_budget
                if self.error_budget > 0 else float(errors), 4)
        for key in ("latency_p50_ms", "latency_p95_ms",
                    "latency_p99_ms"):
            if canary.get(key) is not None:
                record[key] = float(canary[key])
        if int(window.get("fallbacks", 0)):
            record["fallbacks"] = int(window["fallbacks"])
        control = window.get("control") or {}
        if control.get("requests"):
            record["control_requests"] = int(control["requests"])
            record["control_errors"] = int(control.get("errors", 0))
            if control.get("latency_p95_ms") is not None:
                record["control_p95_ms"] = float(
                    control["latency_p95_ms"])
        if reason:
            record["reason"] = str(reason)
        return record

    def _emit(self, record: dict) -> None:
        if self._emit_fn is None:
            return
        try:
            self._emit_fn(record)
        except Exception:
            pass
