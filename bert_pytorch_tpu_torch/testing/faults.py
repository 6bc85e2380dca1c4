"""Deterministic fault-injection points (docs/fault_tolerance.md).

The ROADMAP's "handles as many scenarios as you can imagine" gap was
never the recovery code — it was the PROOF: none of the recovery paths
(resume after a kill, checkpoint walk-back past corruption, transient
shard-read retry, sentinel abort, hung-step detection) were exercised by
anything. This module is the injection half of that proof: a small,
deterministic, explicitly-armed set of fault points that
``tools/chaos_run.py`` and the tier-1 suite drive end to end.

Arming. Faults are OFF unless a spec is armed via ``--fault_spec`` (the
pretraining runner) or the ``BERT_FAULTS`` env var (any process,
including DataLoader workers — the env survives ``fork``/``spawn``).
The spec is a comma-separated list of points::

    die@N            SIGKILL this process at step N (after the step's
                     checkpoint block) — the hard-preemption model
    term@N           SIGTERM this process at step N — exercises the
                     graceful stop + emergency checkpoint path
    nonfinite@N      poison step N's fetched metrics with NaN loss /
    nonfinite@NxK    finite=0 (K consecutive steps) — exercises the
                     sentinel continue/abort policies host-side
    hang@N           sleep S seconds inside step N (default 3600) —
    hang@NxS         exercises the heartbeat-age watchdog
    shard_error      first K (default 1) HDF5 shard loads raise OSError,
    shard_errorxK    then reads are healthy — exercises the data-path
                     retry/backoff (transient-then-healthy)
    wedge@N          wedge the SERVING dispatch thread once N requests
    wedge@NxS        have been served: the dispatch loop's fault check
                     sleeps S seconds (default 3600) while /healthz keeps
                     answering 200 (the thread is alive, just stuck) —
                     the failure mode only the supervisor's heartbeat
                     watchdog can catch (serve/supervisor.py,
                     tools/chaos_serve.py)
    admit_hold@N     hold the serving ASSEMBLER inside the admission
    admit_hold@NxS   window on its Nth formed batch: the fault check
                     emits its injection record (the chaos harness's
                     kill cue) then sleeps S seconds (default 3) with
                     the forming batch open — so a SIGKILL lands with
                     requests provably inside the admission window
                     (serve/service.py pipelined dispatch,
                     tools/chaos_serve.py)
    swap_hold@N      hold a hot-swap OPEN on the Nth swap attempt,
    swap_hold@NxS    between the new params finishing their load and
                     the atomic flip (serve/engine.py swap_params): the
                     fault check emits its injection record (the chaos
                     harness's cue to SIGKILL the replica mid-swap)
                     then sleeps S seconds (default 5) — so a kill
                     lands with two complete param trees in memory and
                     the flip not yet taken, proving in-flight batches
                     only ever see the OLD consistent version
                     (tools/chaos_serve.py swap phase)
    slow_forward     sleep MS milliseconds (default 50) after every
    slow_forwardxMS  serving forward (serve/engine.py execute_staged),
                     off the CPU and outside the GIL: a CPU replica
                     then has a card's fixed service time, so a second
                     replica adds capacity on a loaded box as a second
                     card does (tools/chaos_serve.py --surge)

Everything is keyed on explicit step numbers / call counts — rerunning
the same spec on the same data reproduces the same failure, which is
what lets the chaos harness assert exact resumed-loss trajectories.

Stdlib-only (the jax-free chaos parent imports this by file path), and
every injection emits a schema-v1 ``fault`` telemetry record
(``injected: true``) when the caller passes its emit hook, so injected
faults are distinguishable from real ones in the artifacts.
"""

from __future__ import annotations

import os
import re
import signal
import threading
import time
from typing import Callable, Dict, Optional

FAULTS_ENV = "BERT_FAULTS"

_STEP_POINTS = ("die", "term", "nonfinite", "hang")
_SPEC_RE = re.compile(
    r"^(?P<point>[a-z_]+)(?:@(?P<step>\d+))?(?:x(?P<count>\d+))?$")


class FaultSpecError(ValueError):
    """Malformed ``--fault_spec`` / ``BERT_FAULTS`` string."""


class FaultPlan:
    """Parsed, stateful fault plan for one process.

    State (the shard-error countdown, one-shot step points) is per-plan;
    the module-level singleton (:func:`arm` / :func:`get_plan`) is what
    the dataset layer consults so the runner's CLI arming reaches code
    that never sees args.
    """

    def __init__(self, spec: str = ""):
        self.spec = (spec or "").strip()
        # point -> {"step": N, "count": K}; shard_error keeps a live
        # countdown under a lock (loads happen on the prefetch thread).
        self._points: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self._shard_errors_left = 0
        self._fired: set = set()
        for part in filter(None, (p.strip()
                                  for p in self.spec.split(","))):
            m = _SPEC_RE.match(part)
            if m is None:
                raise FaultSpecError(
                    f"bad fault spec element {part!r} (expected "
                    f"point[@step][xcount], e.g. die@7 or shard_errorx2)")
            point = m.group("point")
            step = m.group("step")
            count = int(m.group("count") or 0)
            if point in _STEP_POINTS or point in ("wedge", "admit_hold",
                                                  "swap_hold"):
                if step is None:
                    raise FaultSpecError(
                        f"fault point {point!r} needs @step (e.g. "
                        f"{point}@7)")
                self._points[point] = {"step": int(step), "count": count}
            elif point == "slow_forward":
                self._points[point] = {"count": count or 50}
            elif point == "shard_error":
                self._shard_errors_left = count or 1
                self._points[point] = {"count": self._shard_errors_left}
            else:
                raise FaultSpecError(
                    f"unknown fault point {point!r} (known: "
                    f"{', '.join(_STEP_POINTS)}, shard_error, wedge, "
                    f"admit_hold, swap_hold, slow_forward)")

    @classmethod
    def from_env(cls) -> "FaultPlan":
        return cls(os.environ.get(FAULTS_ENV, ""))

    @property
    def active(self) -> bool:
        return bool(self._points)

    # -- injection hooks --------------------------------------------------

    def _record(self, fault: str, step: Optional[int] = None, **extra
                ) -> dict:
        rec = {"kind": "fault", "tag": "telemetry", "fault": fault,
               "injected": True}
        if step is not None:
            rec["step"] = int(step)
        rec.update(extra)
        return rec

    def poison_metrics(self, step: int, metrics,
                       emit: Optional[Callable] = None):
        """Host-side NaN injection: replace the fetched loss/finite scalars
        for an armed step (the in-jit finite reduction itself is
        unit-tested; this exercises the host policy end to end)."""
        point = self._points.get("nonfinite")
        if (point is None or not isinstance(metrics, dict)
                or not (point["step"] <= step
                        < point["step"] + max(1, point["count"]))):
            return metrics
        if emit is not None:
            emit(self._record("injected_nonfinite", step))
        poisoned = dict(metrics)
        poisoned["loss"] = float("nan")
        poisoned["finite"] = 0.0
        return poisoned

    def fire_process_faults(self, step: int,
                            emit: Optional[Callable] = None) -> None:
        """die/term/hang points for ``step``; called once per step from
        the training loop (after the checkpoint block, so ``die@N`` tests
        resume from whatever N's cadence had durably written)."""
        for point, action in (("hang", self._hang), ("term", self._term),
                              ("die", self._die)):
            cfg = self._points.get(point)
            key = (point, step)
            if cfg is None or cfg["step"] != step or key in self._fired:
                continue
            self._fired.add(key)
            if emit is not None:
                emit(self._record(f"injected_{point}", step,
                                  **({"hang_s": cfg["count"] or 3600}
                                     if point == "hang" else {})))
            action(cfg)

    def _hang(self, cfg) -> None:
        time.sleep(cfg["count"] or 3600)

    def _term(self, cfg) -> None:
        os.kill(os.getpid(), signal.SIGTERM)

    def _die(self, cfg) -> None:
        # SIGKILL: no handlers, no atexit, no flushing — the honest
        # hard-preemption model. Telemetry written so far survives
        # because the JSONL sink flushes per record.
        os.kill(os.getpid(), signal.SIGKILL)

    def serve_wedge_check(self, requests_served: int,
                          emit: Optional[Callable] = None) -> None:
        """Wedge the calling (dispatch) thread once ``requests_served``
        reaches the armed ``wedge@N`` threshold: emit the injection
        record, then sleep S seconds (default 3600). Called by the
        serving dispatch loop after each processed batch
        (serve/service.py); fires at most once per plan."""
        cfg = self._points.get("wedge")
        if (cfg is None or requests_served < cfg["step"]
                or "wedge" in self._fired):
            return
        self._fired.add("wedge")
        hang_s = cfg["count"] or 3600
        if emit is not None:
            emit(self._record("injected_wedge", None,
                              requests_served=int(requests_served),
                              hang_s=hang_s))
        time.sleep(hang_s)

    def serve_admit_check(self, batches_assembled: int,
                          emit: Optional[Callable] = None) -> None:
        """Hold the calling (assembler) thread inside the admission
        window once ``batches_assembled`` reaches the armed
        ``admit_hold@N`` threshold: emit the injection record FIRST (it
        is the chaos harness's cue to SIGKILL this replica with
        requests captive in the forming batch), then sleep S seconds
        (default 3 — a hold, not a wedge: an unkilled replica resumes
        and serves the batch late). Called by the pipelined assembler
        per formed batch (serve/service.py); fires at most once per
        plan."""
        cfg = self._points.get("admit_hold")
        if (cfg is None or batches_assembled < cfg["step"]
                or "admit_hold" in self._fired):
            return
        self._fired.add("admit_hold")
        hold_s = cfg["count"] or 3
        if emit is not None:
            emit(self._record("injected_admit_hold", None,
                              batches_assembled=int(batches_assembled),
                              hold_s=hold_s))
        time.sleep(hold_s)

    def serve_swap_check(self, swaps_attempted: int,
                         emit: Optional[Callable] = None) -> None:
        """Hold the calling (control) thread inside the swap window on
        the armed ``swap_hold@N``-th swap attempt — AFTER the new params
        finished loading, BEFORE the atomic flip (serve/engine.py
        swap_params): emit the injection record FIRST (the chaos
        harness's cue to SIGKILL this replica mid-swap), then sleep S
        seconds (default 5 — a hold, not a wedge: an unkilled replica
        resumes and completes the flip late). Fires at most once per
        plan."""
        cfg = self._points.get("swap_hold")
        if (cfg is None or swaps_attempted < cfg["step"]
                or "swap_hold" in self._fired):
            return
        self._fired.add("swap_hold")
        hold_s = cfg["count"] or 5
        if emit is not None:
            emit(self._record("injected_swap_hold", None,
                              swaps_attempted=int(swaps_attempted),
                              hold_s=hold_s))
        time.sleep(hold_s)

    def serve_forward_check(self) -> None:
        """Sleep the armed ``slow_forwardxMS`` milliseconds; called by
        the serving engine after every forward, inside its timed span."""
        cfg = self._points.get("slow_forward")
        if cfg is not None:
            time.sleep(cfg["count"] / 1000.0)

    def shard_read_check(self, path: str,
                         emit: Optional[Callable] = None) -> None:
        """Raise a transient OSError for the first armed K shard loads
        (then healthy). Called by the dataset layer inside its retry
        wrapper; thread-safe (loads run on the prefetch thread)."""
        if "shard_error" not in self._points:
            return
        with self._lock:
            if self._shard_errors_left <= 0:
                return
            self._shard_errors_left -= 1
            remaining = self._shard_errors_left
        if emit is not None:
            emit(self._record("injected_shard_error", None, path=path,
                              remaining=remaining))
        raise OSError(
            f"injected transient shard read error for {path} "
            f"({remaining} more armed)")


# -- module-level plan (CLI/env arming reaches the data layer) -----------

_plan = FaultPlan()


def arm(spec: str) -> FaultPlan:
    """Install the process-wide plan (runner ``--fault_spec``); also
    exports it to ``BERT_FAULTS`` so forked/spawned DataLoader workers
    inherit the arming. ``arm("")`` fully disarms (and clears the env
    var) — what in-process tests call in their finally blocks."""
    global _plan
    _plan = FaultPlan(spec)
    if _plan.active:
        os.environ[FAULTS_ENV] = _plan.spec
    else:
        os.environ.pop(FAULTS_ENV, None)
    return _plan


def get_plan() -> FaultPlan:
    """The process-wide plan; lazily picks up ``BERT_FAULTS`` so worker
    processes (which never run the runner CLI) arm themselves."""
    global _plan
    if not _plan.active and os.environ.get(FAULTS_ENV):
        _plan = FaultPlan.from_env()
    return _plan


# -- harness-side corruption (chaos_run.py) ------------------------------

def corrupt_checkpoint(path: str, mode: str = "truncate") -> None:
    """Deterministically damage a checkpoint file IN PLACE (the manifest
    sidecar is left alone, so verification must catch the damage):

    * ``truncate`` — cut the file to half its size (the torn-copy shape);
    * ``flip``     — XOR one byte in the middle (bit rot; size-preserving,
      so only the sha256 check can catch it).
    """
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"{path} is empty; nothing to corrupt")
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
    elif mode == "flip":
        with open(path, "r+b") as f:
            f.seek(size // 2)
            byte = f.read(1)
            f.seek(size // 2)
            f.write(bytes([byte[0] ^ 0xFF]))
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
