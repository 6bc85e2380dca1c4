"""The longitudinal perf ledger: an append-mode, schema-linted JSONL
trajectory of headline performance numbers across runs
(docs/telemetry.md "Perf ledger") — a copy of the JAX package's
``telemetry/ledger.py``, which the port's ``telemetry/report.py
--ledger`` loads. A ledger is a file the caller names; nothing in the
port points it at a ledger it does not own.

A capture diffed against ONE hand-picked baseline artifact is a point
sample — pick a lucky baseline and a slow drift walks in one
in-tolerance step at a time. The ledger records one
``ledger_entry`` per bench leg / telemetry-report run (step p50/p95,
MFU, serve p50/p99, cold start, padding efficiency, plus the config
digest that makes entries comparable) and the drift gate compares the
NEWEST entry against the ROLLING MEDIAN of its leg's history — the
Chowdhery-2022 MFU-accounting lineage only pays off when successive
measurements are comparable over time, which is exactly what a single
baseline cannot give you.

Writer: ``tools/telemetry_report.py --ledger`` appends the run under
test and then gates ("perf ledger drift" by name, exit 1).

Deliberately stdlib-only and torch-free like telemetry/schema.py: its
consumer loads this module by FILE PATH (tools/_bootstrap.py) and must
keep working while the CUDA processes it audits are hung.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import time
from typing import Dict, List, Optional

SCHEMA_VERSION = 1

# Metric direction for the drift verdict ("up" regresses by growing,
# "down" by shrinking) — kept in lockstep with
# schema.LEDGER_METRIC_DIRECTIONS (the lint side of the same contract).
METRIC_DIRECTIONS = {
    "step_ms_p50": "up",
    "step_ms_p95": "up",
    "mfu": "down",
    "serve_p50_ms": "up",
    "serve_p99_ms": "up",
    "cold_start_s": "up",
    "padding_efficiency": "down",
}

DEFAULT_WINDOW = 8          # rolling-median history depth per leg
DEFAULT_TOLERANCE = 0.25    # relative drift allowed vs the median
_MIN_HISTORY = 3            # fewer prior entries than this: no verdict


def config_digest(config: Optional[dict]) -> str:
    """Short stable digest of the run configuration (the comparability
    join key): sorted-key JSON, sha256, 12 hex chars. ``None``/empty
    digests to the fixed ``"unconfigured"`` marker so ad-hoc entries
    still carry a non-empty key."""
    if not config:
        return "unconfigured"
    blob = json.dumps(config, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:12]


def make_entry(leg: str, metrics: Dict[str, float],
               config: Optional[dict] = None,
               digest: Optional[str] = None,
               extra: Optional[dict] = None,
               ts: Optional[float] = None) -> dict:
    """One schema-stamped ``ledger_entry`` record (not yet written).
    Non-finite and negative metric values are dropped rather than
    poisoning the trajectory — an entry is evidence, and evidence that
    fails its own lint is worse than a gap."""
    clean = {}
    for key, value in (metrics or {}).items():
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        if not math.isfinite(value) or value < 0:
            continue
        clean[str(key)] = round(float(value), 6)
    rec = {
        "schema": SCHEMA_VERSION,
        "ts": round(float(ts if ts is not None else time.time()), 3),
        "kind": "ledger_entry",
        "leg": str(leg),
        "config_digest": digest or config_digest(config),
        "metrics": clean,
    }
    if extra:
        for key, value in extra.items():
            rec.setdefault(str(key), value)
    return rec


def append_entry(path: str, leg: str, metrics: Dict[str, float],
                 config: Optional[dict] = None,
                 digest: Optional[str] = None,
                 extra: Optional[dict] = None,
                 ts: Optional[float] = None) -> Optional[dict]:
    """Append one entry to the ledger (append mode — the trajectory is
    the point). Returns the record written, or None when no metric
    survived cleaning (an all-empty entry would fail its own schema
    lint and gate every future run on garbage)."""
    rec = make_entry(leg, metrics, config=config, digest=digest,
                     extra=extra, ts=ts)
    if not rec["metrics"]:
        return None
    line = json.dumps(rec, sort_keys=False)
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        f.write(line + "\n")
    return rec


def read_entries(path: str, leg: Optional[str] = None) -> List[dict]:
    """The ledger's ``ledger_entry`` records in file order (optionally
    one leg's). Unparseable lines are skipped — the schema lint names
    them; the reader's job is the trajectory that exists."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict) or \
                    rec.get("kind") != "ledger_entry":
                continue
            if leg is not None and rec.get("leg") != leg:
                continue
            out.append(rec)
    return out


def _median(values: List[float]) -> float:
    vals = sorted(values)
    n = len(vals)
    mid = n // 2
    if n % 2:
        return vals[mid]
    return 0.5 * (vals[mid - 1] + vals[mid])


def check_drift(entries: List[dict], window: int = DEFAULT_WINDOW,
                tolerance: float = DEFAULT_TOLERANCE) -> List[dict]:
    """Rolling-median drift findings for the NEWEST entry of each
    (leg, config_digest) trajectory.

    For every direction-known metric the newest entry carries, compare
    it against the median of the previous up-to-``window`` entries of
    the same leg AND digest (cross-config comparisons are the
    incomparability the digest exists to refuse). Fewer than
    ``_MIN_HISTORY`` prior entries yields no verdict — two points are a
    line, not a trajectory. Returns one finding dict per drifted
    metric: ``{leg, digest, metric, median, latest, change, window}``.
    """
    findings = []
    by_key: Dict[tuple, List[dict]] = {}
    for rec in entries:
        key = (rec.get("leg"), rec.get("config_digest"))
        by_key.setdefault(key, []).append(rec)
    for (leg, digest), recs in sorted(by_key.items(),
                                      key=lambda kv: str(kv[0])):
        if len(recs) < _MIN_HISTORY + 1:
            continue
        latest = recs[-1].get("metrics") or {}
        history = recs[max(0, len(recs) - 1 - window):-1]
        for metric, direction in METRIC_DIRECTIONS.items():
            new = latest.get(metric)
            if not isinstance(new, (int, float)) or isinstance(new, bool):
                continue
            past = [r["metrics"][metric] for r in history
                    if isinstance(r.get("metrics"), dict)
                    and isinstance(r["metrics"].get(metric), (int, float))
                    and not isinstance(r["metrics"].get(metric), bool)]
            if len(past) < _MIN_HISTORY:
                continue
            med = _median(past)
            if not med:
                continue
            rel = (new - med) / abs(med)
            drifted = rel > tolerance if direction == "up" \
                else rel < -tolerance
            if drifted:
                findings.append({
                    "leg": leg,
                    "digest": digest,
                    "metric": metric,
                    "median": round(med, 6),
                    "latest": round(float(new), 6),
                    "change": round(rel, 4),
                    "tolerance": tolerance,
                    "window": len(past),
                })
    return findings


# Mapping from a telemetry-report summary (telemetry/report.py
# summarize_file) to ledger metric names — the one place the two
# vocabularies meet, so bench.py and telemetry-report land identical
# entries from the same artifact.
SUMMARY_METRIC_MAP = (
    ("step_p50_s", "step_ms_p50", 1000.0),
    ("step_p95_s", "step_ms_p95", 1000.0),
    ("mfu", "mfu", 1.0),
    ("serve_latency_p50_ms", "serve_p50_ms", 1.0),
    ("serve_latency_p99_ms", "serve_p99_ms", 1.0),
    ("serve_cold_start_s", "cold_start_s", 1.0),
    ("padding_efficiency", "padding_efficiency", 1.0),
)


def metrics_from_summary(summary: dict) -> Dict[str, float]:
    """Ledger metrics out of a report summary dict (missing keys simply
    stay absent — a train-only run lands no serve metrics)."""
    out = {}
    for src, dst, scale in SUMMARY_METRIC_MAP:
        v = summary.get(src)
        if isinstance(v, (int, float)) and not isinstance(v, bool) \
                and math.isfinite(v):
            out[dst] = float(v) * scale
    return out


def format_trajectory(entries: List[dict]) -> str:
    """Human rendering of a ledger (the ``perf_ledger.py show`` table)."""
    if not entries:
        return "perf ledger: empty"
    lines = []
    for rec in entries:
        metrics = rec.get("metrics") or {}
        rendered = " ".join(f"{k}={metrics[k]:g}" for k in sorted(metrics))
        lines.append(
            f"{rec.get('ts', 0):>14.3f} {rec.get('leg', '?'):>10} "
            f"{rec.get('config_digest', '?'):>12} {rendered}")
    return "\n".join(lines)
