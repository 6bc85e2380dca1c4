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

The JAX module's ``analyze_executable`` (XLA cost analysis per compiled
executable) has no counterpart here: the port compiles no XLA program.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


class MemorySampler:
    """Window-aggregated allocator watermarks of one device."""

    def __init__(self, emit: Callable[[dict], None], device="cpu"):
        self._emit = emit
        self.device = torch.device(device)
        self.supported: Optional[bool] = None  # unknown until first sample
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
        return (int(stats["allocated_bytes.all.current"]),
                int(stats["allocated_bytes.all.peak"]), int(limit))

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
