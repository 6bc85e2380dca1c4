"""Device-memory watermarks: the port of the JAX package's
``telemetry/memory.py`` :class:`MemorySampler`, on the CUDA caching
allocator's statistics.

The sampler reads ``torch.cuda.memory_stats(device)`` on the existing sync
cadence (the host has just waited for the card there, so "live" means
post-step residency) and emits one ``kind="memory"`` record per telemetry
window, under the JAX record's keys:

* ``bytes_in_use`` — ``allocated_bytes.all.current`` (live tensors);
* ``peak_bytes_in_use`` — ``allocated_bytes.all.peak``, the allocator's
  high-water mark, which ``torch.cuda.max_memory_allocated()`` reads too;
* ``bytes_limit`` — the card's ``total_memory``.

A ``cpu`` device has no allocator statistics: it gets ONE
``memory_supported: false`` note and the sampler disables itself, never a
per-step warning storm. On ``cuda`` a failing read raises: a card that
cannot report its memory is a fault, not "no stats".

:func:`analyze_executable` is the port of the JAX module's static cost
attribution. The port compiles no XLA program to ask, so it counts what
one real call does instead: a :class:`CostCounter` (a
``TorchDispatchMode``) is entered around the first call of each new
shapes digest (telemetry/compile_events.py ``CompileMonitor.instrument``)
and sees every aten op of it, forward, backward and remat recompute alike,
on any thread autograd runs them on. There is no second run. Its fields,
under the JAX record's keys:

* ``flops`` — the sum of ``torch.utils.flop_counter``'s formulas over the
  ops (the matrix products and attention: ``2*M*N*K`` a product; an op
  with no formula, elementwise or a reduction, counts 0);
* ``bytes_accessed`` — each op's input plus output bytes (XLA's
  definition), views and bare allocations (``empty*``) excepted;
* ``argument_bytes`` — the distinct tensors the call reads that existed
  before it began (the batch, the parameters), plus the state the caller
  names (``state``: the parameters and optimizer state a train step keeps
  between calls, read after the call, since an optimizer makes its
  moments at its first step): what the JAX step takes as arguments;
* ``output_bytes`` — the tensors it returns, the pre-existing ones it
  writes in place and the named state (the updated parameters and
  optimizer state, which the JAX step returns);
* ``temp_bytes`` (``full`` on ``cuda`` only) — the caching allocator's
  peak during the call above the bytes allocated on entry;
* ``kernel_notes`` — how many hand-written kernel launches noted their
  cost into the count (below).

A hand-written kernel launched through ``ctypes`` is invisible to a
dispatch mode: each kernel wrapper notes its own cost (ops/kernels/build.py
``note_cost``, routed by telemetry/compile_events.py ``note_kernel`` to the
counter of the instrumented call running) when, and only when, its kernel
ran; on the CPU the wrapper runs the plain version, which the counter
counts op by op. An op on tensor subclasses (FSDP2's
DTensors) is counted at the local shards it runs on, so each rank of a
mesh counts its own work; an op on another subclass is not counted.

Modes (``--telemetry_cost_analysis``, the JAX names): ``off`` emits no
record; ``auto`` (the default) counts; ``full`` counts and reads the
allocator on ``cuda``. ``analysis`` says which a record holds:
``"counted"`` (the counts) or ``"counted_allocator"`` (the counts and
``temp_bytes``). The allocator's peak is reset for that reading; the
run's sampler keeps the peak the allocator held before
(:meth:`MemorySampler.keep_peak`), so its ``peak_bytes_in_use`` stays the
run's high-water mark, while another sampler reads the allocator as it is.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import flop_registry

COST_MODES = ("auto", "off", "full")


class MemorySampler:
    """Window-aggregated allocator watermarks of one device."""

    def __init__(self, emit: Callable[[dict], None], device="cpu"):
        self._emit = emit
        self.device = torch.device(device)
        self.supported: Optional[bool] = None  # unknown until first sample
        # The allocator's peak before a reset this run made (keep_peak).
        self._peak_floor = 0
        self._reset()

    def _reset(self):
        self._samples = 0
        self._live_last = 0
        self._live_max = 0
        self._peak_max = 0
        self._limit = 0

    def _read(self):
        """(live_bytes, peak_bytes, limit_bytes), or None on a
        device without allocator statistics."""
        if self.device.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(self.device)
        limit = torch.cuda.get_device_properties(self.device).total_memory
        peak = max(int(stats["allocated_bytes.all.peak"]), self._peak_floor)
        return int(stats["allocated_bytes.all.current"]), peak, int(limit)

    def keep_peak(self) -> None:
        """Hold the allocator's peak so far as this sampler's floor, before
        the run resets it (``full`` cost analysis), so the run's
        ``peak_bytes_in_use`` stays its high-water mark."""
        if self.device.type == "cuda":
            self._peak_floor = max(
                self._peak_floor,
                int(torch.cuda.max_memory_allocated(self.device)))

    def sample(self, step: int) -> None:
        """Take one watermark sample (call on synced steps only)."""
        if self.supported is False:
            return
        reading = self._read()
        if reading is None:
            self.supported = False
            # One note, then silence: the absence of memory records is
            # explained in-stream instead of by a log storm.
            self._emit({"kind": "memory", "tag": "telemetry",
                        "step": int(step), "memory_supported": False})
            return
        self.supported = True
        live, peak, limit = reading
        self._samples += 1
        self._live_last = live
        self._live_max = max(self._live_max, live)
        self._peak_max = max(self._peak_max, peak)
        self._limit = limit

    def flush(self, step: int) -> Optional[dict]:
        """Emit the window's aggregate record (None when no samples)."""
        if not self._samples:
            return None
        record = {
            "kind": "memory",
            "tag": "telemetry",
            "step": int(step),
            "memory_supported": True,
            "samples": self._samples,
            "n_devices": 1,
            "bytes_in_use": self._live_last,
            "bytes_in_use_max": self._live_max,
            "peak_bytes_in_use": self._peak_max,
            "bytes_limit": self._limit,
        }
        self._reset()
        self._emit(record)
        return record


_VIEWLESS_ALLOCATIONS = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
    torch.ops.aten.empty_strided.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
}
_PLAIN = (torch.Tensor, torch.nn.Parameter)


_NO_LOCAL = object()


def _local_or_none(x):
    """A plain tensor as it is, a DTensor's local shard, _NO_LOCAL for
    another subclass; anything else as it is."""
    if not isinstance(x, torch.Tensor) or type(x) in _PLAIN:
        return x
    local = getattr(x, "_local_tensor", None)
    return local if type(local) in _PLAIN else _NO_LOCAL


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(values) -> list:
    """The tensors among ``values``, and in the lists and tuples among
    them (an aten op's arguments and results nest no deeper)."""
    found = []
    for v in values:
        if isinstance(v, torch.Tensor):
            found.append(v)
        elif isinstance(v, (list, tuple)):
            found += [t for t in v if isinstance(t, torch.Tensor)]
    return found


_OP_INFO: dict = {}


def _op_info(func) -> tuple:
    """(flop formula or None, whether its bytes count, the (index, name)
    of each argument it writes) of an aten op, worked out once."""
    info = _OP_INFO.get(func)
    if info is None:
        written = tuple((i, a.name) for i, a in
                        enumerate(func._schema.arguments)
                        if a.alias_info is not None and a.alias_info.is_write)
        info = _OP_INFO[func] = (
            flop_registry.get(func._overloadpacket),
            not (func.is_view or func in _VIEWLESS_ALLOCATIONS), written)
    return info


class CostCounter(TorchDispatchMode):
    """Counts the flops and bytes of every aten op run while it is entered
    (and the kernel notes made meanwhile); :meth:`fields` reads them out as
    a ``compile_cost`` record's fields."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.kernel_notes = 0
        self._created: set = set()       # storages made during the call
        self._arguments: dict = {}       # pre-existing tensors read
        self._written: dict = {}         # pre-existing tensors written

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # Keep __torch_dispatch__ unwrapped: the wrapper that disables
        # compilation inside it imports torch._dynamo (some 800 modules)
        # at the first op, and the port compiles nothing.
        return False

    def note(self, cost) -> None:
        """Add one hand-written kernel's launch (its ``KernelCost``,
        ops/kernels/build.py)."""
        self.flops += int(cost.flops)
        self.bytes_accessed += int(cost.bytes_accessed)
        self.kernel_notes += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if all(t in _PLAIN for t in types):
            self._count(func, args, kwargs, out)
        else:
            # A tensor subclass ran the op (FSDP2's DTensors): count it at
            # the local shards it holds, where it has them.
            local = tree_map(_local_or_none, (args, kwargs, out))
            if not any(x is _NO_LOCAL for x in tree_leaves(local)):
                self._count(func, *local)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        formula, counts_bytes, written = _op_info(func)
        inputs = _tensors(args) + _tensors(kwargs.values())
        outputs = _tensors((out,))
        if any(t.is_meta for t in inputs) or any(t.is_meta for t in outputs):
            return  # shape propagation, not work
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not counts_bytes:
            if func in _VIEWLESS_ALLOCATIONS:  # made here: no argument
                self._created.update(t.untyped_storage().data_ptr()
                                     for t in outputs)
            return
        in_storages = set()
        seen = set()
        for t in inputs:
            nbytes = t.numel() * t.element_size()
            key = (t.data_ptr(), nbytes)
            if not nbytes or key in seen:
                continue
            seen.add(key)
            self.bytes_accessed += nbytes
            storage = t.untyped_storage().data_ptr()
            in_storages.add(storage)
            if storage not in self._created:
                self._arguments[key] = nbytes
        for index, name in written:
            value = args[index] if index < len(args) else kwargs.get(name)
            for t in _tensors((value,)):
                nbytes = t.numel() * t.element_size()
                if nbytes and (t.untyped_storage().data_ptr()
                               not in self._created):
                    self._written[(t.data_ptr(), nbytes)] = nbytes
        for t in outputs:
            self.bytes_accessed += t.numel() * t.element_size()
            storage = t.untyped_storage().data_ptr()
            if storage not in in_storages:
                self._created.add(storage)

    def fields(self, returned=None, state=()) -> dict:
        """The counts as record fields; ``returned`` is what the counted
        call returned (its tensors are outputs), ``state`` the tensors the
        caller keeps between calls (arguments and outputs both)."""
        arguments, outputs = dict(self._arguments), dict(self._written)
        kept = {(t.data_ptr(), _nbytes(t)): _nbytes(t)
                for t in map(_local_or_none, state)
                if t is not _NO_LOCAL and t.numel()}
        arguments.update(kept)
        outputs.update(kept)
        for t in tree_leaves(returned):
            if isinstance(t, torch.Tensor) and t.numel():
                outputs[(t.data_ptr(), _nbytes(t))] = _nbytes(t)
        return {"flops": float(self.flops),
                "bytes_accessed": float(self.bytes_accessed),
                "argument_bytes": int(sum(arguments.values())),
                "output_bytes": int(sum(outputs.values())),
                "kernel_notes": int(self.kernel_notes),
                "analysis": "counted"}


def training_state(model, optimizer):
    """``state()`` for :meth:`CompileMonitor.instrument`: the model's
    parameters and the optimizer's state tensors (this rank's shards)."""
    def state():
        tensors = list(model.parameters())
        for entry in optimizer.state.values():
            tensors += [v for v in entry.values()
                        if isinstance(v, torch.Tensor)]
        return tensors

    return state


class _AllocatorWindow:
    """The ``full`` mode's reading: the allocator's peak during the block
    above the bytes allocated on entry (``temp_bytes``), on ``cuda``."""

    def __init__(self, device, sampler=None):
        self.device = torch.device(device)
        self.sampler = sampler
        self.temp_bytes = None

    def __enter__(self):
        torch.cuda.synchronize(self.device)
        if self.sampler is not None:
            self.sampler.keep_peak()
        self._entry = torch.cuda.memory_allocated(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        self.temp_bytes = int(torch.cuda.max_memory_allocated(self.device)
                              - self._entry)
        return False


def analyze_executable(fn, args, kwargs, mode: str = "auto", device=None,
                       state=None, counter: Optional[CostCounter] = None,
                       sampler: Optional[MemorySampler] = None):
    """``(result, fields)``: one real call of ``fn(*args, **kwargs)`` under
    ``counter`` (a new :class:`CostCounter` when None), and its
    ``compile_cost`` fields (None for ``off``). Kernel notes reach the
    counter of an instrumented call (telemetry/compile_events.py), not one
    made here. ``state()``, read after the call, lists the tensors ``fn``
    keeps between calls (:func:`training_state`). With ``mode="full"`` and
    a ``cuda`` ``device`` the fields add ``temp_bytes`` and ``analysis``
    reads ``"counted_allocator"``; ``sampler`` (the run's
    :class:`MemorySampler`) keeps the peak that reading resets."""
    if mode not in COST_MODES:
        raise ValueError(f"cost-analysis mode must be one of {COST_MODES}, "
                         f"got {mode!r}")
    if mode == "off":
        return fn(*args, **kwargs), None
    window = None
    if (mode == "full" and device is not None
            and torch.device(device).type == "cuda"):
        window = _AllocatorWindow(device, sampler)
    counter = counter if counter is not None else CostCounter()
    with window or contextlib.nullcontext(), counter:
        result = fn(*args, **kwargs)
    fields = counter.fields(result, state() if state is not None else ())
    if window is not None:
        fields["temp_bytes"] = window.temp_bytes
        fields["analysis"] = "counted_allocator"
    return result, fields
