"""Crash flight recorder: a bounded ring of each process's last
telemetry records and log lines, flushed atomically to
``postmortem.json``. A copy of the JAX package's ``telemetry/flightrec.py``
(stdlib-only there too), kept line for line apart from this docstring
and :meth:`FlightRecorder.log_handler`, which returns a handler of the
port's ``utils/logging.py``.

When a training runner or serving replica dies, the JSONL artifact says
what the run looked like; it does not say what the process saw in its
final seconds. The :class:`FlightRecorder` keeps a byte-bounded ring of
the newest entries and persists it:

* **incident flush** — a teed record with ``kind`` in ``fault`` /
  ``divergence`` / ``sentinel`` flushes immediately (the preemption
  fault record every runner and run_server emits rides this path, so a
  drained process leaves forensics too);
* **periodic flush** — at most every ``flush_interval_s`` seconds on
  the note path, so a SIGKILLed process — which gets no atexit, no
  excepthook, nothing — still leaves an at-most-seconds-stale
  postmortem;
* **crash flush** — an installed ``sys.excepthook`` chains to the
  previous hook after flushing with the exception rendered into the
  payload, and an ``atexit`` handler catches exits that never reached
  :meth:`close`;
* **clean exit** — :meth:`close` (``TrainTelemetry.close`` /
  run_server teardown) disarms the exit hooks and REMOVES the
  postmortem unless an incident flush happened during the run: a clean
  run leaves no stale forensics for the next harvest to misread.

Writes are tmp + rename: a reader never sees a partial file. The ring
never exceeds ``max_bytes`` of serialized payload; an oversized single
entry is replaced by a stub naming its size. All shared state sits
behind one lock: background emitters (watchdog, async-writer threads)
note records concurrently with the train loop.
"""

from __future__ import annotations

import atexit
import collections
import json
import math
import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional

from bert_pytorch_tpu_torch.utils.logging import Handler

# Record kinds that flush the ring immediately (the incident signal).
INCIDENT_KINDS = ("fault", "divergence", "sentinel")

# A single over-budget entry is stubbed, never allowed to evict the
# whole ring.
_STUB_KEYS = ("kind", "tag", "event")


def _sanitize(obj):
    """JSON-safe copy: non-finite floats become null (the JSONL sink's
    convention — a postmortem full of bare NaN would be unreadable by
    the strict parsers the timeline feeds)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {str(k): _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, (str, int, bool)) or obj is None:
        return obj
    return str(obj)


class FlightRecorder:
    def __init__(self, path: str, process: str = "train",
                 max_bytes: int = 192 * 1024,
                 flush_interval_s: float = 2.0,
                 max_line_chars: int = 400,
                 clock: Callable[[], float] = time.time):
        self.path = path
        self.process = str(process)
        self.max_bytes = max(1024, int(max_bytes))
        self.flush_interval_s = float(flush_interval_s)
        self.max_line_chars = int(max_line_chars)
        self._clock = clock
        self._lock = threading.Lock()
        # Disk writes serialize on their own lock with a sequence
        # number: payloads are built under _lock but written after
        # releasing it, and a descheduled periodic flush must never
        # land AFTER (and clobber) a newer crash/incident payload.
        self._write_lock = threading.Lock()
        self._flush_seq = 0     # under _lock: payload build order
        self._written_seq = 0   # under _write_lock: newest on disk
        # Ring entries: ("record", json_str, nbytes) | ("log", str, nbytes)
        self._ring: "collections.deque" = collections.deque()
        self._bytes = 0
        self._dropped = 0           # entries evicted by the byte bound
        self._noted = 0             # entries ever noted
        self._incident = False      # an incident flush happened this run
        self._closed = False
        self._last_flush = 0.0
        self._last_reason: Optional[str] = None
        self._unflushed = 0         # entries noted since the last flush
        self._exit_hooks_installed = False
        self._prev_excepthook = None

    # -- producer side ----------------------------------------------------

    def note_record(self, rec: dict) -> None:
        """Append one telemetry record; incident kinds flush the ring
        immediately, anything else at most every ``flush_interval_s``."""
        if not isinstance(rec, dict):
            return
        entry = dict(rec)
        entry.setdefault("ts", round(self._clock(), 3))
        try:
            line = json.dumps(_sanitize(entry))
        except (TypeError, ValueError):
            line = json.dumps({"unserializable": str(type(rec))})
        kind = rec.get("kind")
        incident = kind in INCIDENT_KINDS
        with self._lock:
            if self._closed:
                return
            self._append_locked("record", line)
            reason = None
            now = self._clock()
            if incident:
                fault = rec.get("fault") or rec.get("reason")
                reason = f"{kind}:{fault}" if fault else str(kind)
            elif now - self._last_flush >= self.flush_interval_s:
                reason = "periodic"
            if reason is None:
                return
            payload = self._payload_locked(reason)
            self._incident = self._incident or incident
            self._last_flush = now
            self._last_reason = reason
            self._unflushed = 0
            self._flush_seq += 1
            seq = self._flush_seq
        self._write(payload, seq)

    def note_line(self, line: str) -> None:
        """Append one log line (truncated to ``max_line_chars``)."""
        text = str(line)[: self.max_line_chars]
        with self._lock:
            if self._closed:
                return
            self._append_locked("log", text)

    def log_handler(self):
        """A ``utils/logging`` :class:`Handler` teeing the process log
        into the ring — append it to a ``Logger``'s handlers beside the
        real sinks."""
        return _RecorderLogHandler(self)

    def tee(self, emit: Optional[Callable[[dict], None]]
            ) -> Callable[[dict], None]:
        """Wrap an emit callable so every record also lands in the ring
        (run_server threads its serve telemetry through this)."""

        def teed(rec: dict) -> None:
            self.note_record(rec)
            if emit is not None:
                emit(rec)

        return teed

    def _append_locked(self, typ: str, payload: str) -> None:
        nbytes = len(payload.encode("utf-8", "replace"))
        if nbytes > self.max_bytes:
            # Stub, never evict-everything: keep the entry's identity.
            try:
                rec = json.loads(payload) if typ == "record" else {}
            except ValueError:
                rec = {}
            stub = {"truncated": True, "bytes": nbytes}
            stub.update({k: rec[k] for k in _STUB_KEYS if k in rec})
            payload = json.dumps(stub)
            nbytes = len(payload.encode("utf-8"))
        self._ring.append((typ, payload, nbytes))
        self._bytes += nbytes
        self._noted += 1
        self._unflushed += 1
        while self._bytes > self.max_bytes and len(self._ring) > 1:
            _, _, evicted = self._ring.popleft()
            self._bytes -= evicted
            self._dropped += 1

    # -- flush side -------------------------------------------------------

    def ring_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def flush(self, reason: str, exc: Optional[BaseException] = None
              ) -> Optional[str]:
        """Persist the ring now (tmp + rename); returns the path written
        or None when the recorder is closed. ``exc`` renders a bounded
        traceback into the payload (the crash-flush context atexit alone
        cannot provide)."""
        with self._lock:
            if self._closed:
                return None
            payload = self._payload_locked(reason, exc=exc)
            self._incident = self._incident or reason not in (
                "periodic", "clean")
            self._last_flush = self._clock()
            self._last_reason = reason
            self._unflushed = 0
            self._flush_seq += 1
            seq = self._flush_seq
        self._write(payload, seq)
        return self.path

    def _payload_locked(self, reason: str,
                        exc: Optional[BaseException] = None) -> dict:
        records = []
        lines = []
        for typ, payload, _ in self._ring:
            if typ == "record":
                try:
                    records.append(json.loads(payload))
                except ValueError:
                    records.append({"unparseable": payload[:120]})
            else:
                lines.append(payload)
        out = {
            "process": self.process,
            "pid": os.getpid(),
            "reason": reason,
            "flushed_at": round(self._clock(), 3),
            "ring_bytes": self._bytes,
            "ring_entries": len(self._ring),
            "dropped": self._dropped,
            "noted": self._noted,
            "records": records,
            "lines": lines,
        }
        if exc is not None:
            out["exception"] = "".join(traceback.format_exception(
                type(exc), exc, exc.__traceback__))[-4000:]
        return out

    def _write(self, payload: dict, seq: int) -> None:
        """tmp + rename (a harvesting reader never sees a torn file),
        ordered by flush sequence (an older payload never replaces a
        newer one already on disk)."""
        with self._write_lock:
            if seq < self._written_seq:
                return
            self._written_seq = seq
            tmp = f"{self.path}.tmp"
            try:
                os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                            exist_ok=True)
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(payload, f)
                os.replace(tmp, self.path)
            except OSError:
                pass  # forensics must never take the process down

    # -- lifecycle --------------------------------------------------------

    def install_exit_hooks(self) -> "FlightRecorder":
        """Arm the crash paths: an excepthook that flushes with the
        traceback (chaining to the previous hook), and an atexit flush
        for exits that never reached :meth:`close`. Call once, from the
        process entry point (telemetry/cli.from_args, run_server)."""
        with self._lock:
            if self._exit_hooks_installed:
                return self
            self._exit_hooks_installed = True
            self._prev_excepthook = sys.excepthook
        atexit.register(self._atexit_flush)
        sys.excepthook = self._excepthook
        return self

    def _excepthook(self, exc_type, exc, tb) -> None:
        try:
            self.flush("crash", exc=exc)
        except Exception:
            pass
        prev = self._prev_excepthook or sys.__excepthook__
        prev(exc_type, exc, tb)

    def _atexit_flush(self) -> None:
        with self._lock:
            closed = self._closed
            # An excepthook flush already captured this exit WITH its
            # traceback; re-flushing here would overwrite that payload
            # with a contextless one. Only flush when something was
            # noted since the last flush (an empty ring has no
            # forensic value either).
            stale = self._unflushed > 0
        if not closed and stale:
            # The process is exiting without ever reaching close():
            # a crash path (os._exit sidesteps this; SIGKILL relies on
            # the periodic flush instead).
            self.flush("atexit")

    def close(self, clean: bool = True) -> None:
        """End of run. ``clean=True`` removes the postmortem unless an
        incident flush happened (a clean run leaves no stale forensics
        for the next crash harvest to misread); ``clean=False`` flushes
        one final snapshot instead."""
        if not clean:
            self.flush("close")
        with self._lock:
            if self._closed:
                return
            self._closed = True
            incident = self._incident
        if self._prev_excepthook is not None and \
                sys.excepthook == self._excepthook:
            sys.excepthook = self._prev_excepthook
        if clean and not incident:
            try:
                os.remove(self.path)
            except OSError:
                pass


class _RecorderLogHandler(Handler):
    """A ``utils/logging`` handler: log lines and structured log records
    tee into the ring (the 'last log lines' half of the postmortem).
    Never a real sink — write failures are impossible and close() is a
    no-op (the recorder owns its own lifecycle)."""

    def __init__(self, recorder: FlightRecorder):
        super().__init__(verbose=True, is_primary=True)
        self._recorder = recorder

    def write_message(self, message: str) -> None:
        self._recorder.note_line(message)

    def write_record(self, record: dict) -> None:
        self._recorder.note_record(dict(record))

    def close(self) -> None:
        pass


def read_postmortem(path: str) -> Optional[dict]:
    """Parse a postmortem file; None when absent/torn (the tmp+rename
    write makes torn unlikely, but a reader must not crash on it)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            out = json.load(f)
        return out if isinstance(out, dict) else None
    except (OSError, ValueError):
        return None
