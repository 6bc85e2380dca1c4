"""The host thread sampler + on-demand capture state machine behind
``POST /profilez``: a copy of the JAX package's ``telemetry/sampler.py``,
with the same caps and parameters, driving a ``torch.profiler`` window in
place of a ``jax.profiler`` one.

A ``torch.profiler`` trace answers "where is DEVICE time going" — but the
background planes of a process (the dispatch stages, the async
checkpoint writer, the flight-recorder flush paths) are HOST threads,
whose frames a device trace does not name. :class:`ThreadSampler` closes
that gap with the stdlib alone: a periodic ``sys._current_frames()``
sweep over the process's threads, attributing each sample's SELF time to
the leaf frame (collapsed-stack rendering kept per leaf for drill-down),
bounded in both duration and sample count so a capture can never grow
without limit.

:class:`CaptureController` is the arm/collect state machine both HTTP
planes share: ``POST /profilez`` (telemetry/introspect.py for trainers,
serve/http.py for replicas) calls :meth:`CaptureController.arm` from an
HTTP worker thread; the owning loop calls :meth:`CaptureController.tick`
at every step/dispatch boundary. A second arm while a capture is armed or
active is refused (the HTTP planes map that to 409): profiler traces
cannot nest, and two POSTs must never stack two trace starts.

Stdlib-only at import time: the trace facility arrives by INJECTION (a
:class:`telemetry.profiler.ProfilerWindow` whose ``begin``/``end`` the
controller drives), so a controller without one works sampler-only.
One addition to the JAX controller: ``tick(..., force=True)`` collects an
active capture before its deadline, which the training facade does at
the end of a run, so a capture never outlives the loop it measures.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

# Hard ceilings an arm request cannot exceed — a capture is a bounded
# measurement, not a resident profiler.
MAX_DURATION_S = 60.0
MAX_SAMPLES = 20000
MIN_INTERVAL_S = 0.001

DEFAULT_DURATION_S = 2.0
DEFAULT_INTERVAL_S = 0.01
DEFAULT_TOP_K = 10
_STACK_DEPTH = 12  # collapsed-stack rendering depth (leaf-most frames)


def _frame_key(frame) -> str:
    """Stable leaf-frame identity: ``file.py:function``. The basename
    (not the full path) so frames aggregate across installs, and the
    function name (not the line) so a hot function is one row, not one
    row per bytecode offset the sampler happened to land on."""
    code = frame.f_code
    return f"{os.path.basename(code.co_filename)}:{code.co_name}"


def _collapsed(frame) -> str:
    """Root->leaf collapsed stack (the flamegraph convention), bounded
    to the leaf-most ``_STACK_DEPTH`` frames."""
    parts: List[str] = []
    while frame is not None and len(parts) < _STACK_DEPTH:
        parts.append(_frame_key(frame))
        frame = frame.f_back
    return ";".join(reversed(parts))


class ThreadSampler:
    """Bounded periodic ``sys._current_frames`` sampler.

    ``include`` is an optional tuple of thread-name prefixes to sample
    (e.g. ``("serve-", "telemetry-")``); None samples every thread
    except the sampler's own. Self time is attributed per
    (thread, leaf frame); :meth:`result` folds the tallies into the
    ``top_frames`` table a ``profile_window`` record carries. Threads are
    told apart by ident, not by name (the JAX sampler's key): two threads
    of one name — two services' ``serve-executor`` in one process — are
    two rows, and no row counts more samples than the sampler took.
    """

    def __init__(self, interval_s: float = DEFAULT_INTERVAL_S,
                 max_samples: int = 2000,
                 max_duration_s: float = MAX_DURATION_S,
                 include: Optional[tuple] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.interval_s = max(MIN_INTERVAL_S, float(interval_s))
        self.max_samples = max(1, min(int(max_samples), MAX_SAMPLES))
        self.max_duration_s = max(0.0, min(float(max_duration_s),
                                           MAX_DURATION_S))
        self.include = tuple(include) if include else None
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Tallies: written by the sampler thread
        # per tick, read by result() after stop() joins — but stop() may
        # race a final in-flight tick, so every touch takes the lock.
        self._lock = threading.Lock()
        self._samples = 0
        self._counts: Dict[tuple, int] = {}
        self._stacks: Dict[tuple, str] = {}

    def _sampled(self, name: str) -> bool:
        if self._thread is not None and name == self._thread.name:
            return False  # never profile the profiler
        if self.include is None:
            return True
        return any(name.startswith(p) for p in self.include)

    def _sample_once_locked(self) -> None:
        """One sweep (called with ``_lock`` held — the suffix contract):
        attribute this instant's self time to each sampled thread's leaf
        frame."""
        by_ident = {t.ident: t.name for t in threading.enumerate()
                    if t.ident is not None}
        for ident, frame in sys._current_frames().items():
            name = by_ident.get(ident)
            if name is None or not self._sampled(name):
                continue
            key = (name, _frame_key(frame), ident)
            self._counts[key] = self._counts.get(key, 0) + 1
            if key not in self._stacks:
                self._stacks[key] = _collapsed(frame)
        self._samples += 1

    def _run(self) -> None:
        deadline = self._clock() + self.max_duration_s
        while not self._stop.is_set():
            with self._lock:
                if self._samples >= self.max_samples:
                    break
                self._sample_once_locked()
            if self._clock() >= deadline:
                break
            self._stop.wait(self.interval_s)

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("sampler already started (one-shot)")
        self._thread = threading.Thread(
            target=self._run, name="telemetry-sampler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def result(self, top_k: int = DEFAULT_TOP_K) -> dict:
        """Fold the tallies: total sample count, the threads that ever
        appeared, and the top-K (thread, leaf-frame) self-time rows."""
        with self._lock:
            samples = self._samples
            counts = dict(self._counts)
            stacks = dict(self._stacks)
        rows = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        # Share of ALL attributed self-time (not of sweep count): every
        # sweep tallies one hit per live thread, so dividing by sweeps
        # would sum to ~n_threads across frames — the shares must
        # decompose the capture to <= 1 (the schema invariant).
        total = sum(counts.values())
        top = []
        for (thread, frame, ident), n in rows[:max(1, int(top_k))]:
            top.append({
                "frame": frame,
                "thread": thread,
                "samples": n,
                "share": round(n / total, 4) if total else 0.0,
                "stack": stacks.get((thread, frame, ident), frame),
            })
        return {
            "samples": samples,
            "threads": sorted({t for (t, _f, _i) in counts}),
            "top_frames": top,
        }


def _tree_bytes(path: Optional[str]) -> int:
    """On-disk size of a trace artifact directory (0 for absent/empty)."""
    if not path or not os.path.isdir(path):
        return 0
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


class CaptureController:
    """Arm-at-boundary capture state machine (idle -> armed -> active).

    ``source`` labels the records (``"trainer"``/``"replica"``...);
    ``covered_unit`` is what boundaries count (``"steps"``/
    ``"requests"``). ``window`` is an optional
    :class:`telemetry.profiler.ProfilerWindow` driven via its
    ``begin``/``end`` — None (or a ``begin`` that refuses because
    another trace is active) degrades the capture to sampler-only,
    recorded as an empty ``trace_path``. ``emit`` receives the finished
    ``profile_window`` record (a JSONLHandler's ``write_record`` or
    TrainTelemetry.emit stamps schema/ts).

    Thread contract: :meth:`arm` and :meth:`status` may be called from
    any thread (HTTP workers); :meth:`tick` only by the owning boundary
    loop. All shared state lives under one lock; the trace begin/end and
    sampler start/stop run OUTSIDE it (``end`` blocks in
    ``torch.cuda.synchronize``; holding the lock there would stall
    /statsz for the sync's duration).
    """

    def __init__(self, source: str, covered_unit: str = "steps",
                 window=None, trace_dir: Optional[str] = None,
                 include_threads: Optional[tuple] = None,
                 emit: Optional[Callable[[dict], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.source = str(source)
        self.covered_unit = str(covered_unit)
        self.window = window
        self.trace_dir = trace_dir
        self.include_threads = include_threads
        self.emit = emit
        self._clock = clock
        self._lock = threading.Lock()
        # The one shared slot: phase + the armed
        # request's parameters + capture bookkeeping + the last record.
        self._state: dict = {
            "phase": "idle",       # idle | armed | active
            "params": None,        # the armed request (dict)
            "trigger": None,
            "seq": 0,              # capture counter (trace subdir names)
            "captures": 0,         # completed captures
            "started_at": None,
            "start_position": None,
            "deadline": None,
            "last": None,          # last finished record (trimmed)
        }
        self._sampler: Optional[ThreadSampler] = None  # active-phase only

    # -- any thread (HTTP workers) ---------------------------------------

    def arm(self, duration_s: float = DEFAULT_DURATION_S,
            sample_interval_s: float = DEFAULT_INTERVAL_S,
            max_samples: int = 2000, top_k: int = DEFAULT_TOP_K,
            trigger: str = "ondemand"):
        """Request a capture at the next boundary. Returns
        ``(ok, payload)``; ``ok=False`` with the current phase when a
        capture is already armed or active — the HTTP planes answer 409
        (a second profiler start while one runs would crash the owning
        loop)."""
        try:
            duration_s = float(duration_s)
            sample_interval_s = float(sample_interval_s)
            max_samples = int(max_samples)
            top_k = int(top_k)
        except (TypeError, ValueError) as exc:
            return False, {"error": f"bad capture parameter: {exc}"}
        if not duration_s > 0:
            return False, {"error": "duration_s must be positive"}
        duration_s = min(duration_s, MAX_DURATION_S)
        with self._lock:
            if self._state["phase"] != "idle":
                return False, {
                    "error": "capture already in progress",
                    "phase": self._state["phase"],
                }
            self._state["phase"] = "armed"
            self._state["trigger"] = (trigger if trigger in
                                      ("ondemand", "fleet") else "ondemand")
            self._state["params"] = {
                "duration_s": duration_s,
                "sample_interval_s": max(MIN_INTERVAL_S, sample_interval_s),
                "max_samples": max(1, min(max_samples, MAX_SAMPLES)),
                "top_k": max(1, top_k),
            }
            payload = {"armed": True, "source": self.source,
                       "covered_unit": self.covered_unit}
            payload.update(self._state["params"])
        return True, payload

    def status(self) -> dict:
        """Live capture status for /statsz."""
        with self._lock:
            out = {
                "phase": self._state["phase"],
                "captures": self._state["captures"],
            }
            if self._state["phase"] == "active" and \
                    self._state["started_at"] is not None:
                out["active_for_s"] = round(
                    self._clock() - self._state["started_at"], 3)
            last = self._state["last"]
            if last is not None:
                out["last"] = dict(last)
        return out

    # -- owning boundary loop only ---------------------------------------

    def tick(self, position: int, sync_target=None,
             force: bool = False) -> Optional[dict]:
        """One step/dispatch boundary. Starts an armed capture, finishes
        an expired one (or, with ``force``, an active one before its
        deadline: the end of the owning loop); returns the finished
        ``profile_window`` record (also emitted) or None. Must be called
        from the thread that owns the boundary — the trace begin/end and
        the sampler lifecycle are serialized by that ownership, only the
        phase state is shared."""
        with self._lock:
            phase = self._state["phase"]
            if phase == "armed" and not force:
                params = dict(self._state["params"])
                self._state["seq"] += 1
                seq = self._state["seq"]
            elif phase == "active":
                expired = force or self._clock() >= self._state["deadline"]
                if not expired:
                    return None
            else:
                return None

        if phase == "armed":
            sampler = ThreadSampler(
                interval_s=params["sample_interval_s"],
                max_samples=params["max_samples"],
                max_duration_s=params["duration_s"] + 5.0,
                include=self.include_threads)
            trace_path = ""
            if self.window is not None and self.trace_dir:
                sub = os.path.join(self.trace_dir, f"ondemand_{seq}")
                if self.window.begin(trace_dir=sub):
                    trace_path = sub
            sampler.start()
            now = self._clock()
            with self._lock:
                self._state["phase"] = "active"
                self._state["started_at"] = now
                self._state["start_position"] = int(position)
                self._state["deadline"] = now + params["duration_s"]
                self._state["params"] = params
                self._state["params"]["trace_path"] = trace_path
                self._sampler = sampler
            return None

        # active + expired: collect.
        with self._lock:
            sampler = self._sampler
            params = dict(self._state["params"])
            started = self._state["started_at"]
            start_pos = self._state["start_position"]
            trigger = self._state["trigger"]
        sampler.stop()
        trace_path = params.get("trace_path", "")
        if trace_path and self.window is not None:
            self.window.end(sync_target=sync_target)
        folded = sampler.result(top_k=params["top_k"])
        record = {
            "kind": "profile_window",
            "source": self.source,
            "trigger": trigger or "ondemand",
            "covered": max(0, int(position) - int(start_pos)),
            "covered_unit": self.covered_unit,
            "duration_s": round(self._clock() - started, 3),
            "sample_interval_s": params["sample_interval_s"],
            "samples": folded["samples"],
            "threads": folded["threads"],
            "top_frames": folded["top_frames"],
            "trace_path": trace_path,
            "trace_bytes": _tree_bytes(trace_path),
        }
        last = {k: record[k] for k in (
            "trigger", "covered", "covered_unit", "duration_s", "samples",
            "trace_path", "trace_bytes")}
        last["top_frame"] = (folded["top_frames"][0]["frame"]
                             if folded["top_frames"] else None)
        with self._lock:
            self._state["phase"] = "idle"
            self._state["params"] = None
            self._state["started_at"] = None
            self._state["start_position"] = None
            self._state["deadline"] = None
            self._state["captures"] += 1
            self._state["last"] = last
            self._sampler = None
        if self.emit is not None:
            self.emit(record)
        return record
