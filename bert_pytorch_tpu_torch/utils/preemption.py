"""Graceful preemption for the port's runners: a copy of the JAX package's
``utils/preemption.py``.

A preempting scheduler (SLURM, Kubernetes eviction, a cloud maintenance
event) delivers SIGTERM with a short grace period; an operator delivers
SIGINT. :class:`GracefulStop` installs handlers that only set a flag: the
training loop acts on it at a step boundary, writes an emergency
checkpoint and exits with :data:`EXIT_PREEMPTED`, so the scheduler can
tell "checkpointed, resubmit me" from success (0) and from a crash.
Handlers stay installed through the checkpoint write (a re-delivered
signal must not kill it mid-file) and are restored on exit, exceptions
included.
"""

from __future__ import annotations

import signal
from typing import Optional

# 75 = EX_TEMPFAIL ("temporary failure; user is invited to retry"): the
# closest sysexits.h code to "preempted cleanly, resubmit me".
EXIT_PREEMPTED = 75

_DEFAULT_SIGNALS = ("SIGTERM", "SIGINT", "SIGUSR1")


class GracefulStop:
    """Flag-setting handlers for the preemption signals; a context manager
    that restores the previous handlers on exit::

        with GracefulStop() as stop:
            for batch in loader:
                ...
                if stop.requested:
                    break   # the runner writes the emergency checkpoint
        sys.exit(EXIT_PREEMPTED if stop.requested else 0)

    ``signals`` are names resolved on the platform (``SIGUSR1`` is skipped
    where absent). Where a handler cannot be installed (not the main
    thread), the loop never sees ``requested``."""

    def __init__(self, signals=_DEFAULT_SIGNALS, on_signal=None):
        self._names = tuple(signals)
        self._on_signal = on_signal
        self._old: dict = {}
        self.requested = False
        self.signum: Optional[int] = None

    @property
    def signal_name(self) -> Optional[str]:
        if self.signum is None:
            return None
        try:
            return signal.Signals(self.signum).name
        except ValueError:
            return str(self.signum)

    def _handler(self, signum, frame):
        # The first delivery wins; repeats are absorbed, except a second
        # SIGINT, which aborts at once (first Ctrl-C graceful, second not).
        if self.requested:
            if signum == signal.SIGINT:
                raise KeyboardInterrupt
            return
        self.requested = True
        self.signum = signum
        if self._on_signal is not None:
            try:
                self._on_signal(signum)
            except Exception:
                pass  # never raise from signal context

    def install(self) -> "GracefulStop":
        for name in self._names:
            sig = getattr(signal, name, None)
            if sig is None:
                continue
            try:
                self._old[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):
                pass  # not the main thread, or the platform refuses
        return self

    def restore(self) -> None:
        for sig, handler in self._old.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                pass
        self._old = {}

    def __enter__(self) -> "GracefulStop":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.restore()


def preemption_record(step: int, stop: GracefulStop) -> dict:
    """The ``fault`` record a runner logs when it acts on a stop request
    (the JAX package's telemetry schema v1)."""
    return {
        "kind": "fault",
        "tag": "telemetry",
        "fault": "preemption",
        "step": int(step),
        "signal": stop.signal_name,
        "injected": False,
    }
