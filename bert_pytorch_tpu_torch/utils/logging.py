"""Multi-sink structured logging: a copy of the JAX package's
``utils/logging.py`` (its handlers and ``Logger``) for the port's runners.

Four handler types: stream, append-mode text file, CSV, and JSONL (the
machine-readable telemetry sink, schema-versioned — see
``bert_pytorch_tpu_torch/telemetry/schema.py``). ``log(tag=..., step=...,
**metrics)`` writes one structured record to every sink. The JAX
package's TensorBoard handler is not copied: the port writes no
TensorBoard files. The JAX module's process-wide ``logger`` singleton is
not copied either: a runner builds its own :class:`Logger` for the run.

Two orthogonal gates, deliberately separate:

* ``is_primary`` — is this process rank 0? Non-primary processes write no
  file artifacts at all (file/CSV/JSONL handlers stay closed).
* ``verbose`` — purely cosmetic: does the STREAM handler echo to the
  terminal? A quiet (``verbose=False``) rank-0 run still produces every
  file artifact.

``is_primary`` defaults to the value of ``verbose``.
"""

from __future__ import annotations

import csv
import json
import math
import os
import sys
import threading
import time
from typing import Iterable, Optional


class Handler:
    def __init__(self, verbose: bool = True, is_primary: Optional[bool] = None):
        self.verbose = verbose
        self.is_primary = verbose if is_primary is None else is_primary

    def write_message(self, message: str) -> None:  # pragma: no cover
        raise NotImplementedError

    def write_record(self, record: dict) -> None:
        self.write_message(
            " | ".join(f"{k}: {_fmt(v)}" for k, v in record.items())
        )

    def close(self) -> None:
        pass


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    return v


class StreamHandler(Handler):
    def __init__(self, verbose: bool = True, stream=None,
                 is_primary: Optional[bool] = None):
        super().__init__(verbose, is_primary)
        self.stream = stream or sys.stdout

    def write_message(self, message: str) -> None:
        # Stream output is the one place ``verbose`` applies: quiet runs
        # keep their file artifacts but stop echoing to the terminal.
        if self.verbose and self.is_primary:
            self.stream.write(message + "\n")
            self.stream.flush()


class FileHandler(Handler):
    def __init__(self, path: str, overwrite: bool = False, verbose: bool = True,
                 is_primary: Optional[bool] = None):
        super().__init__(verbose, is_primary)
        self.path = path
        if self.is_primary:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "w" if overwrite else "a")
        else:
            self._f = None

    def write_message(self, message: str) -> None:
        if self._f is not None:
            self._f.write(message + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class CSVHandler(Handler):
    """One CSV row per structured record. The column set WIDENS when a later
    record brings new keys (e.g. eval metrics or telemetry gauges appearing
    mid-run): the file is rewritten once with the union header and old rows
    blank-filled — nothing is silently dropped. Missing keys stay blank."""

    def __init__(self, path: str, overwrite: bool = False, verbose: bool = True,
                 is_primary: Optional[bool] = None):
        super().__init__(verbose, is_primary)
        self.path = path
        self._fieldnames: Optional[list] = None
        if self.is_primary:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "w" if overwrite else "a", newline="")
        else:
            self._f = None

    def write_message(self, message: str) -> None:
        pass  # CSV carries records only

    def _open_writer(self, write_header: bool) -> None:
        self._writer = csv.DictWriter(
            self._f, fieldnames=self._fieldnames, extrasaction="ignore"
        )
        if write_header:
            self._writer.writeheader()

    def _existing_header(self) -> Optional[list]:
        """First row of the file being appended to (None when empty) — the
        prior run's column set, which seeds ``_fieldnames`` so a resumed
        run widens relative to the FILE's header, not this run's first
        record (else the old header would be misread as a data row)."""
        if self._f.tell() == 0:
            return None
        with open(self.path, newline="") as f:
            return next(csv.reader(f), None)

    def _widen(self, novel: list) -> None:
        """Rewrite the file with the union header; existing rows get blanks
        for the new columns. Metric CSVs are small (one row per log step),
        and new keys appear a handful of times per run, so the rewrite is
        cheap — and strictly better than dropping the new metrics."""
        old_fields = self._fieldnames
        self._fieldnames = old_fields + novel
        self._f.close()
        rows = []
        with open(self.path, newline="") as f:
            reader = csv.reader(f)
            for i, row in enumerate(reader):
                if i == 0 and row == old_fields:
                    continue  # old header; replaced below
                rows.append(dict(zip(old_fields, row)))
        self._f = open(self.path, "w", newline="")
        self._open_writer(write_header=True)
        for row in rows:
            self._writer.writerow(row)

    def write_record(self, record: dict) -> None:
        if self._f is None:
            return
        if self._fieldnames is None:
            existing = self._existing_header()
            if existing:
                self._fieldnames = existing
                self._open_writer(write_header=False)
            else:
                self._fieldnames = list(record.keys())
                self._open_writer(write_header=True)
        novel = [k for k in record if k not in self._fieldnames]
        if novel:
            self._widen(novel)
        self._writer.writerow({k: record.get(k, "") for k in self._fieldnames})
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class JSONLHandler(Handler):
    """One JSON object per line — the machine-readable sink of the
    telemetry layer.

    Every line carries ``schema`` (the telemetry record schema version,
    ``telemetry/schema.py``) and ``ts`` (unix seconds) in addition to the
    record's own fields; non-finite floats are serialized as JSON ``null``
    (NaN is not valid JSON and would poison downstream parsers — the
    sentinel record's ``finite`` flag carries the signal instead).
    ``telemetry.schema.validate_file`` lints a stream against the schema.

    Thread-safe: background threads also emit here (the hung-step
    watchdog), and interleaved ``TextIOWrapper.write`` calls could
    otherwise tear two records into one invalid line. One lock serializes
    each record's write+flush (and close).
    """

    def __init__(self, path: str, overwrite: bool = False, verbose: bool = True,
                 is_primary: Optional[bool] = None):
        super().__init__(verbose, is_primary)
        self.path = path
        self._lock = threading.Lock()
        if self.is_primary:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "w" if overwrite else "a")
        else:
            self._f = None

    def write_message(self, message: str) -> None:
        pass  # JSONL carries records only; prose goes to the text sink

    def write_record(self, record: dict) -> None:
        # Cheap unlocked fast-path for non-primary ranks: the only None
        # transition is close(), and the locked re-check below covers
        # that race — but serializing every hot-path record just to drop
        # it would be per-step waste on every rank.
        if self._f is None:  # torchlint: disable=LK501
            return
        from bert_pytorch_tpu_torch.telemetry.schema import SCHEMA_VERSION

        rec = {"schema": SCHEMA_VERSION, "ts": round(time.time(), 3)}
        rec.update(record)
        line = json.dumps(rec, default=str, allow_nan=False,
                          cls=_FiniteEncoder) + "\n"
        with self._lock:
            if self._f is None:
                return
            self._f.write(line)
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


class _FiniteEncoder(json.JSONEncoder):
    """Serialize non-finite floats as null instead of raising (allow_nan
    only controls the invalid-JSON NaN/Infinity spellings)."""

    def iterencode(self, o, _one_shot=False):
        return super().iterencode(_sanitize_nonfinite(o), _one_shot)


def _sanitize_nonfinite(obj):
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _sanitize_nonfinite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize_nonfinite(v) for v in obj]
    return obj


class Logger:
    def __init__(self):
        self.handlers: list[Handler] = [StreamHandler()]

    def init(self, handlers: Iterable[Handler]) -> None:
        # Close the handlers being replaced (including the default
        # StreamHandler) so re-init never leaks open files.
        self.close()
        self.handlers = list(handlers)

    def info(self, message: str) -> None:
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        for h in self.handlers:
            h.write_message(f"[{stamp}] {message}")

    def log(self, **record) -> None:
        for h in self.handlers:
            h.write_record(record)

    def close(self) -> None:
        for h in self.handlers:
            h.close()
