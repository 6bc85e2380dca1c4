"""Bounded ``torch.profiler`` trace windows for the training loop, and the
``begin``/``end`` facility the on-demand profiling plane drives
(telemetry/sampler.py, ``POST /profilez``): the port of the JAX package's
``telemetry/profiler.py``, on ``torch.profiler`` in place of
``jax.profiler``.

``--profile_steps`` accepts either ``"N"`` (N steady-state steps starting
after the first step, i.e. the window ``[2, 2+N)`` in step-in-run terms)
or ``"N:M"`` (explicit half-open step range). The window auto-stops: when
the range's last step completes — or the run ends inside the window — the
device is synchronized (so the trace holds the full device work of every
traced step) and the trace is written as one Chrome trace
(``trace_<pid>.json``) into the window's directory.

:meth:`ProfilerWindow.begin` and :meth:`ProfilerWindow.end` open and close
any number of further windows on the same instance, each writing its trace
into the directory ``begin`` names (an on-demand capture's
``<profile_dir>/ondemand_<seq>``). A profiler is a process-wide singleton
in practice (one CUPTI subscriber), so every start goes through the
module-level exclusivity latch: ``begin`` REFUSES (returns False) instead
of stacking traces, which is what lets the startup window and the HTTP
planes share one process without coordinating. ``stop`` and
``maybe_stop`` end the startup window only: an on-demand window is ended
by the controller that began it.

While a trace is active each step's dispatch is wrapped in
``torch.profiler.record_function("train/<step>")``, standing in for the
JAX ``StepTraceAnnotation("train", step_num=...)``: the trace viewer then
groups a step's host ranges under one named range.

On ``cuda`` the trace records CPU and CUDA activities (every kernel on the
card with its device time, whichever thread launched it); on ``cpu`` host
activity only. No shapes and no stacks are recorded: both cost host time
on every traced op.
"""

from __future__ import annotations

import contextlib
import os
import threading
import warnings
from typing import Optional, Tuple

import torch

# Process-wide trace exclusivity: flipped by whichever window's start/stop
# wins, checked by every other would-be starter.
_TRACE_LOCK = threading.Lock()
_TRACE_ACTIVE = False


def _acquire_trace() -> bool:
    global _TRACE_ACTIVE
    with _TRACE_LOCK:
        if _TRACE_ACTIVE:
            return False
        _TRACE_ACTIVE = True
        return True


def _release_trace() -> None:
    global _TRACE_ACTIVE
    with _TRACE_LOCK:
        _TRACE_ACTIVE = False


def trace_active() -> bool:
    """Whether ANY trace window is live in this process (status surface)."""
    with _TRACE_LOCK:
        return _TRACE_ACTIVE


def parse_profile_spec(spec) -> Optional[Tuple[int, int]]:
    """``"N"``/``N`` -> (2, 2+N) steady-state window; ``"N:M"`` -> (N, M);
    falsy / "0" -> None (disabled). Raises ValueError on malformed specs."""
    if spec is None:
        return None
    if isinstance(spec, int):
        return (2, 2 + spec) if spec > 0 else None
    text = str(spec).strip()
    if not text:
        return None
    if ":" in text:
        start_s, stop_s = text.split(":", 1)
        start, stop = int(start_s), int(stop_s)
        if start < 1 or stop <= start:
            raise ValueError(
                f"--profile_steps range must satisfy 1 <= N < M, got {text!r}")
        return (start, stop)
    n = int(text)
    return (2, 2 + n) if n > 0 else None


class ProfilerWindow:
    """Drives bounded trace windows: the one-shot startup window of
    ``--profile_steps`` from per-step calls (``done`` latches after it),
    and unbounded ``begin``/``end`` windows. ``device`` picks the
    activities (CUDA as well as CPU on a ``cuda`` device) and the
    synchronize before a trace stops. ``last_trace`` is the path of the
    newest trace written.
    """

    def __init__(self, spec, trace_dir: Optional[str], device="cpu"):
        self.range = parse_profile_spec(spec)
        self.trace_dir = trace_dir or "profile"
        self.device = torch.device(device)
        self.active = False
        self.done = False
        self.last_trace: Optional[str] = None
        self._prof = None
        self._out_dir: Optional[str] = None
        # True only while the SPEC-driven startup window is tracing: the
        # auto-stop rule applies to it alone, so an on-demand window at
        # step 50 is not ended by the startup range having ended.
        self._startup_active = False

    def begin(self, trace_dir: Optional[str] = None) -> bool:
        """Start a trace window writing into ``trace_dir`` (default the
        window's own directory). Returns False — never raises, never
        stacks — when this window is already tracing or ANY other trace
        is active in the process; a profiler that fails to start is
        reported as a warning."""
        if self.active or not _acquire_trace():
            return False
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=activities, record_shapes=False,
                           with_stack=False)
            prof.start()
        except RuntimeError as exc:
            # A refused/failed start must release the latch or no trace
            # could ever start again in this process.
            _release_trace()
            warnings.warn(f"profiler window did not start: {exc}")
            return False
        self._prof = prof
        self._out_dir = trace_dir or self.trace_dir
        self.active = True
        return True

    def end(self, sync_target=None) -> bool:
        """Stop the active window: synchronize the device (so the trace
        holds the device work of every launch in the window), stop the
        profiler and write the Chrome trace. ``sync_target`` is accepted
        for the JAX signature; the synchronize covers it."""
        if not self.active:
            return False
        try:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._prof.stop()
            os.makedirs(self._out_dir, exist_ok=True)
            path = os.path.join(self._out_dir, f"trace_{os.getpid()}.json")
            self._prof.export_chrome_trace(path)
            self.last_trace = path
        finally:
            self._prof = None
            self.active = False
            self._startup_active = False
            _release_trace()
        return True

    def maybe_start(self, step_in_run: int) -> bool:
        """Start the startup trace when ``step_in_run`` enters the spec's
        window. Returns False outside the window, after it, or while ANY
        other trace is active in the process."""
        if (self.range is None or self.active or self.done
                or step_in_run < self.range[0]
                or step_in_run >= self.range[1]):
            return False
        if not self.begin():
            return False
        self._startup_active = True
        return True

    def annotation(self, step_in_run: int):
        """Context manager wrapping one step's dispatch."""
        if self.active:
            return torch.profiler.record_function(f"train/{step_in_run}")
        return contextlib.nullcontext()

    def maybe_stop(self, step_in_run: int) -> bool:
        """Stop when the startup window's last step completed (auto-stop)."""
        if not self._startup_active or step_in_run < self.range[1] - 1:
            return False
        return self.stop()

    def stop(self) -> bool:
        """Stop the startup window (end of run inside it) and latch the
        one-shot ``done``; an on-demand window is left to its
        controller."""
        if not self._startup_active:
            return False
        self.end()
        self.done = True
        return True
