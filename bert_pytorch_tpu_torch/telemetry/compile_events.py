"""Compile observability for the port: every kernel-library build becomes a
telemetry record.

The JAX package's ``telemetry/compile_events.py`` turns each XLA compile
into a ``kind: "compile"`` record, from ``jax.monitoring`` events. The
port compiles no XLA program; its counterpart of a compile is the ``nvcc``
build of a kernel library (``ops/kernels/build.py``), cached on disk by a
hash of its sources and flags. A cold start builds, a warm start finds the
library already built; mixing the two in one ``cold_start_s`` says
nothing, so :func:`report_build` gives each library one record with the
JAX record's shape::

    {"kind": "compile", "tag": "telemetry", "fn": "flash_attention_infer",
     "shapes_digest": "3f0c9a...", "compile_s": 27.9,
     "backend_compile_s": 27.9, "cache": "miss"}

``fn`` is the kernel source's name, ``shapes_digest`` the library's hash,
``compile_s`` and ``backend_compile_s`` the seconds ``nvcc`` took (0.0 on
a hit), and ``cache`` is ``"miss"`` when ``nvcc`` ran and ``"hit"`` when
the library was already built (on disk, or loaded earlier in the
process).

The build layer knows nothing of telemetry: it reports to whichever
:class:`CompileMonitor` is installed (module-level registry, like the JAX
module's active-monitor routing). ``run_server`` installs its monitor for
the process's life; an engine's warmup installs its own for the warmup's
duration and counts the events inside it as start-up's.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional

_lock = threading.Lock()
_installed: List["CompileMonitor"] = []


def report_build(fn: str, digest: str, seconds: float, built: bool) -> None:
    """One library's build outcome to every installed monitor: ``built``
    when ``nvcc`` ran (``cache: "miss"``), else a hit."""
    with _lock:
        monitors = list(_installed)
    for monitor in monitors:
        monitor.record(fn, digest, seconds, built)


class CompileMonitor:
    """Receives the build layer's events while installed; emits one
    ``compile`` record per event through ``emit`` and keeps them in
    :attr:`events`."""

    def __init__(self, emit: Optional[Callable[[dict], None]] = None):
        self._emit = emit
        self.events: list = []  # everything emitted, for programmatic access
        self._depth = 0

    def install(self) -> "CompileMonitor":
        """Receive build events until :meth:`uninstall` (nested installs
        count: the monitor stays until the last uninstall)."""
        with _lock:
            self._depth += 1
            if self._depth == 1:
                _installed.append(self)
        return self

    def uninstall(self) -> None:
        with _lock:
            if self._depth == 0:
                return
            self._depth -= 1
            if self._depth == 0:
                _installed.remove(self)

    @contextlib.contextmanager
    def installed(self):
        """Installed for the ``with`` block."""
        self.install()
        try:
            yield self
        finally:
            self.uninstall()

    def note(self, record: dict) -> None:
        """Keep and emit one caller-built record through this monitor's
        sink, beside the compile records: the serve engine's
        ``kind="autotune"`` geometry records ride here, as in the JAX
        package."""
        self.events.append(record)
        if self._emit is not None:
            self._emit(record)

    def record(self, fn: str, digest: str, seconds: float,
               built: bool) -> dict:
        """The ``compile`` record of one library build (or hit)."""
        seconds = round(float(seconds), 4)
        record = {
            "kind": "compile",
            "tag": "telemetry",
            "fn": fn,
            "shapes_digest": digest,
            "compile_s": seconds,
            "backend_compile_s": seconds,
            "cache": "miss" if built else "hit",
        }
        self.events.append(record)
        if self._emit is not None:
            self._emit(record)
        return record
