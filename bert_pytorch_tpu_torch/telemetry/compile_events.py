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

:meth:`CompileMonitor.instrument` is the port of the JAX monitor's
wrapper around a step function (the trainers' ``train_step``,
``eval_step``, ``predict_step``; ``TrainTelemetry.instrument``). Each call
takes :func:`shapes_digest` of its tensors; the first call of each new
digest emits one ``compile`` record for the function::

    {"kind": "compile", "tag": "telemetry", "fn": "train_step",
     "shapes_digest": "9be1c2d0a4f3", "compile_s": 3.41,
     "backend_compile_s": 2.97, "cache": "miss"}

``compile_s`` is that call's wall seconds (on ``cuda`` up to a
synchronize after it), ``backend_compile_s`` the ``nvcc`` seconds of the
kernel libraries built inside it, and ``cache`` is ``"miss"`` when
``nvcc`` ran, ``"hit"`` when a library was found built on disk, and
``"jit"`` when no build happened. A thread-local current call receives
the builds :func:`report_build` sees meanwhile; a build on a thread
without one (autograd runs a CUDA backward on a thread of its own) counts
toward the call active in the process. Unless ``cost_analysis`` is
``"off"``, that same first call runs under the cost counter
(telemetry/memory.py :func:`analyze_executable`) and one ``compile_cost``
record follows the ``compile`` record, joined by ``shapes_digest``. The
counter rides on the call record, and :func:`note_kernel` routes a
hand-written kernel's cost note (a ``ctypes`` launch the counter cannot
see; ops/kernels/build.py ``note_cost``) to it as :func:`report_build`
routes a build. A call whose digest was seen costs one digest and one set
lookup.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import time
from typing import Callable, List, Optional

import torch
from torch.utils._pytree import tree_flatten

_lock = threading.Lock()
_installed: List["CompileMonitor"] = []


_tls = threading.local()
# The instrumented calls running in the process, innermost last.
_calls: list = []


def _current_call() -> Optional[dict]:
    call = getattr(_tls, "call", None)
    if call is None:
        with _lock:
            call = _calls[-1] if _calls else None
    return call


def report_build(fn: str, digest: str, seconds: float, built: bool) -> None:
    """One library's build outcome to every installed monitor: ``built``
    when ``nvcc`` ran (``cache: "miss"``), else a hit; and to the
    instrumented call running, if any."""
    call = _current_call()
    if call is not None:
        if built:
            call["misses"] += 1
            call["backend_compile_s"] += float(seconds)
        else:
            call["hits"] += 1
    with _lock:
        monitors = list(_installed)
    for monitor in monitors:
        monitor.record(fn, digest, seconds, built)


def note_kernel(cost_fn, *args, **kwargs) -> None:
    """A hand-written kernel ran: add ``cost_fn(*args, **kwargs)`` (its
    ``KernelCost``) to the cost counter of the instrumented call running,
    if it has one; computed only then."""
    # Lock-free fast path for serving launches (nothing instrumented is
    # running): an instrumented call is pushed on the loop thread before
    # its kernels launch, and autograd's engine orders the backward's
    # launches after that push; the locked read in _current_call decides.
    if not _calls:  # torchlint: disable=LK501
        return
    call = _current_call()
    counter = call and call["counter"]
    if counter is not None:
        counter.note(cost_fn(*args, **kwargs))


def shapes_digest(tree) -> str:
    """The 12-hex sha1 of a call's structure and its tensors' shape, dtype
    and device (never values; a leaf that is not a tensor enters by its
    type alone)."""
    leaves, spec = tree_flatten(tree)
    parts = [str(spec)]
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            parts.append(f"{leaf.dtype}{tuple(leaf.shape)}{leaf.device}")
        else:
            parts.append(f"py:{type(leaf).__name__}")
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:12]


class CompileMonitor:
    """Receives the build layer's events while installed; emits one
    ``compile`` record per event through ``emit`` and keeps them in
    :attr:`events`."""

    def __init__(self, emit: Optional[Callable[[dict], None]] = None, *,
                 cost_analysis: str = "off", device=None, sampler=None):
        """``cost_analysis`` is :meth:`instrument`'s mode (``auto``,
        ``off``, ``full``; checked here, so a bad mode fails before the
        first step); ``device`` the device its calls run on (``cuda``
        synchronizes the first call's clock and takes ``full``'s allocator
        reading); ``sampler`` the run's ``MemorySampler``, whose peak
        ``full``'s reset of the allocator's must not lower."""
        from bert_pytorch_tpu_torch.telemetry.memory import COST_MODES

        if cost_analysis not in COST_MODES:
            raise ValueError(f"cost_analysis must be one of {COST_MODES}, "
                             f"got {cost_analysis!r}")
        self._emit = emit
        self.cost_analysis = cost_analysis
        self.device = torch.device(device) if device is not None else None
        self.sampler = sampler
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

    def instrument(self, fn, name: str, state=None):
        """``fn`` wrapped so the first call of each new shapes digest emits
        its ``compile`` record (and, unless ``cost_analysis`` is off, its
        ``compile_cost`` record from that same call). ``state()`` lists
        the tensors ``fn`` keeps between calls (telemetry/memory.py
        ``training_state``), counted as its arguments and outputs."""
        seen: set = set()

        def wrapper(*args, **kwargs):
            digest = shapes_digest((args, kwargs))
            if digest in seen:
                return fn(*args, **kwargs)
            out = self._first_call(fn, name, digest, args, kwargs, state)
            seen.add(digest)
            return out

        wrapper.__name__ = f"{name}_monitored"
        return wrapper

    def _first_call(self, fn, name, digest, args, kwargs, state):
        from bert_pytorch_tpu_torch.telemetry import memory

        counter = (None if self.cost_analysis == "off"
                   else memory.CostCounter())
        call = {"backend_compile_s": 0.0, "misses": 0, "hits": 0,
                "counter": counter}
        prev = getattr(_tls, "call", None)
        _tls.call = call
        with _lock:
            _calls.append(call)
        cuda = self.device is not None and self.device.type == "cuda"
        t0 = time.perf_counter()
        try:
            out, fields = memory.analyze_executable(
                fn, args, kwargs, self.cost_analysis, self.device, state,
                counter, self.sampler)
            if cuda:
                torch.cuda.synchronize(self.device)
        finally:
            _tls.call = prev
            with _lock:
                _calls.remove(call)
        elapsed = time.perf_counter() - t0
        cache = ("miss" if call["misses"] else "hit" if call["hits"]
                 else "jit")
        self.note({"kind": "compile", "tag": "telemetry", "fn": name,
                   "shapes_digest": digest, "compile_s": round(elapsed, 4),
                   "backend_compile_s": round(call["backend_compile_s"], 4),
                   "cache": cache})
        if fields is not None:
            self.note({"kind": "compile_cost", "tag": "telemetry",
                       "fn": name, "shapes_digest": digest, **fields})
        return out

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
        self.note(record)
        return record
