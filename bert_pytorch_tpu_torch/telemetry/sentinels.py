"""Failure sentinels: non-finite detection policy + a liveness heartbeat
(a copy of the JAX package's ``telemetry/sentinels.py``).

The in-step half lives in the train step (pretrain.make_train_step emits
``metrics["finite"]`` — an ``isfinite`` reduction over the step's losses
and global grad-norm, one device scalar; the finetune runners fall back to
a host ``isfinite`` of the fetched loss). This module is the host half:
the policy applied to that scalar, and the heartbeat file a supervisor
reads instead of guessing liveness from checkpoint mtimes.

``policy="abort"`` turns a divergence into a loud, bounded failure:
``patience`` CONSECUTIVE observed non-finite steps raise
:class:`NonFiniteError` (one bad step does not kill the run; a divergence
does). ``policy="continue"`` (default) logs a sentinel record per observed
bad step and keeps going.

Observation cadence: reading the finite scalar is a device sync, so the
sentinel sees a step only when the runner synced it — every
``--telemetry_sync_every``-th step plus every log step. A sampled cadence
stretches detection accordingly (patience 3 at cadence 4 aborts within
~12 steps of a hard divergence, not 3); runs that want step-exact abort
pass ``--telemetry_sync_every 1``.
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from typing import Callable, Optional


class NonFiniteError(RuntimeError):
    """Raised by the abort policy after ``patience`` consecutive bad steps."""


class FailureSentinel:
    POLICIES = ("continue", "abort")

    def __init__(self, policy: str = "continue", patience: int = 3,
                 emit: Optional[Callable[[dict], None]] = None):
        if policy not in self.POLICIES:
            raise ValueError(
                f"sentinel policy must be one of {self.POLICIES}, got "
                f"{policy!r}")
        self.policy = policy
        self.patience = max(1, int(patience))
        self._emit = emit
        self.consecutive = 0
        self.total_nonfinite = 0

    def observe(self, step: int, finite, loss=None) -> bool:
        """Feed one step's finite flag (truthy = healthy). Returns True when
        healthy; emits a sentinel record and applies the policy otherwise."""
        if bool(finite):
            self.consecutive = 0
            return True
        self.consecutive += 1
        self.total_nonfinite += 1
        record = {
            "kind": "sentinel",
            "tag": "telemetry",
            "step": int(step),
            "finite": 0,
            "loss": None if loss is None else float(loss),
            "consecutive_nonfinite": self.consecutive,
            "policy": self.policy,
        }
        if self._emit is not None:
            self._emit(record)
        if self.policy == "abort" and self.consecutive >= self.patience:
            raise NonFiniteError(
                f"non-finite loss/grad-norm for {self.consecutive} "
                f"consecutive steps (last step {step}); aborting per "
                f"--sentinel_policy abort")
        return False


class Heartbeat:
    """Rank-0 liveness file: ``{"step", "wallclock", "last_loss",
    "counter"}``, written atomically (tmp + rename) so a reader never sees
    a torn record. ``counter`` increments monotonically per beat — a
    restarted run resumes it from the file, so "is this process alive"
    is simply "did counter advance between two reads".

    ``beat(..., hold_s=S)`` declares that the process may not beat for up
    to S seconds from now (a bounded operation that holds the
    interpreter, such as collecting a profiler trace): every beat until
    then carries ``"hold_s"``, the seconds left, and the fleet
    supervisor's watchdog adds them to its timeout. ``hold_s=0`` ends
    the hold. A beat with no hold writes the JAX package's four keys.
    Beats may come from several threads."""

    def __init__(self, path: Optional[str], is_primary: bool = True,
                 clock: Callable[[], float] = time.time):
        self.path = path if is_primary else None
        self._clock = clock
        self.counter = 0
        self._last_loss = None
        self._hold_until = 0.0
        self._lock = threading.Lock()
        if self.path:
            previous = self.read(self.path)
            if previous:
                self.counter = int(previous.get("counter", 0))
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)

    def beat(self, step: int, last_loss=None,
             hold_s: Optional[float] = None) -> None:
        if not self.path:
            return
        with self._lock:
            now = self._clock()
            if hold_s is not None:
                self._hold_until = now + max(0.0, float(hold_s))
            self.counter += 1
            if last_loss is not None:
                self._last_loss = float(last_loss)
            payload = {
                "step": int(step),
                "wallclock": round(now, 3),
                "last_loss": self._last_loss,
                "counter": self.counter,
            }
            if self._hold_until > now:
                payload["hold_s"] = round(self._hold_until - now, 3)
            tmp = f"{self.path}.tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)

    @staticmethod
    def read(path: str) -> Optional[dict]:
        """Parse a heartbeat file; None when absent/torn (callers treat
        both as 'no evidence of liveness')."""
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None


class HeartbeatWatchdog:
    """Hung-step detector.

    A deadlocked input queue or a hung storage mount stalls training
    WITHOUT crashing it — the loop just never reaches the next step
    boundary, and nothing in-process says so. The watchdog is a daemon thread fed a liveness note at
    every completed step (``TrainTelemetry.step_done``); when the age of
    the newest note exceeds ``max_age_s`` it emits one schema-v1
    ``fault`` record (``fault: "hung_step"``) and a warning, then
    re-arms only after progress resumes (one flag per stall, never a
    storm).

    Arming starts at the FIRST note, so the first step (its kernel builds
    and allocator warm-up) never counts as a hang; size ``max_age_s`` generously —
    it bounds detection, and a false positive is only a log line (the
    watchdog flags, it never kills: the process may be seconds from
    recovering, and killing is the scheduler's call).
    """

    def __init__(self, max_age_s: float, emit: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic,
                 poll_s: Optional[float] = None):
        if max_age_s <= 0:
            raise ValueError(f"max_age_s must be > 0, got {max_age_s}")
        self.max_age_s = float(max_age_s)
        self._emit = emit
        self._clock = clock
        self._poll_s = poll_s if poll_s is not None else max(
            0.05, self.max_age_s / 4.0)
        self._lock = threading.Lock()
        self._last: Optional[tuple] = None  # (clock(), step)
        self._flagged = False
        self.stalls_flagged = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def note(self, step: int) -> None:
        """One completed step: refresh the liveness timestamp and re-arm."""
        with self._lock:
            self._last = (self._clock(), int(step))
            self._flagged = False

    def check(self) -> Optional[dict]:
        """The ``fault`` record if the run is stalled and unflagged, else
        None. Pure of the thread machinery so tests drive it with a fake
        clock instead of sleeping."""
        with self._lock:
            if self._last is None or self._flagged:
                return None
            noted_at, step = self._last
            age = self._clock() - noted_at
            if age < self.max_age_s:
                return None
            self._flagged = True
            self.stalls_flagged += 1
        return {
            "kind": "fault", "tag": "telemetry", "fault": "hung_step",
            "injected": False, "step": step,
            "age_s": round(age, 3), "max_age_s": self.max_age_s,
        }

    def _loop(self) -> None:
        while not self._stop.wait(self._poll_s):
            record = self.check()
            if record is not None:
                warnings.warn(
                    f"watchdog: no step completed for {record['age_s']:.1f}s "
                    f"(> {self.max_age_s:.1f}s) after step "
                    f"{record['step']}; the run may be hung")
                if self._emit is not None:
                    self._emit(record)

    def start(self) -> "HeartbeatWatchdog":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="telemetry-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
