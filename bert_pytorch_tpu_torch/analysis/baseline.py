"""Baseline file: grandfathered findings that do not fail the gate.

The committed ``bert_pytorch_tpu_torch/torchlint_baseline.json`` holds
findings that are accepted debt, each with a ``justification`` (the
JAX package's ``jaxlint_baseline.json`` rules, kept). Matching
is by ``(check, path, source)`` — the stripped source text of the
flagged line, NOT its line number — so unrelated edits that shift lines
do not resurrect baselined findings, while any edit to the flagged line
itself (including a fix) drops it out of the baseline. ``torchlint
--write-baseline`` regenerates the file from the current findings;
``--prune-baseline`` (default behavior of --write-baseline) drops
entries that no longer match anything.

The gate's contract: this file starts empty — real findings get FIXED,
the baseline is for the rare justified exception.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List, Tuple

from bert_pytorch_tpu_torch.analysis.core import Finding

BASELINE_VERSION = 1
DEFAULT_BASENAME = "torchlint_baseline.json"


def load_baseline(path: str) -> List[dict]:
    """Entries of a baseline file; [] when the file does not exist.
    Raises ValueError on a malformed file — a torn baseline must fail
    the gate loudly, not silently un-grandfather everything."""
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, dict) or data.get("version") != BASELINE_VERSION \
            or not isinstance(data.get("entries"), list):
        raise ValueError(
            f"{path}: not a v{BASELINE_VERSION} torchlint baseline "
            "({'version': 1, 'entries': [...]})")
    for entry in data["entries"]:
        if not isinstance(entry, dict) \
                or not all(k in entry for k in ("check", "path", "source")):
            raise ValueError(
                f"{path}: baseline entries need check/path/source keys")
    return data["entries"]


def merge_entries(existing: List[dict], findings: Iterable[Finding],
                  linted_paths: Iterable[str],
                  justification: str = "grandfathered by --write-baseline"
                  ) -> List[dict]:
    """Baseline entries after a ``--write-baseline`` run that linted only
    ``linted_paths``: entries for UNLINTED files survive untouched (a
    subset run must never delete another file's grandfathered entry or
    its hand-written justification), entries for linted files survive
    iff they still match a finding (keeping their justification — only
    genuinely-stale ones are pruned), and findings no existing entry
    covers get fresh entries."""
    linted = set(linted_paths)
    kept = [e for e in existing if e["path"] not in linted]
    in_scope = [e for e in existing if e["path"] in linted]
    new, matched, _stale = apply_baseline(findings, in_scope)
    matched_keys = {(f.check, f.path, f.source) for f in matched}
    kept += [e for e in in_scope
             if (e["check"], e["path"], e["source"]) in matched_keys]
    kept += [{"check": f.check, "path": f.path, "source": f.source,
              "justification": justification} for f in new]
    return kept


def write_entries(path: str, entries: List[dict]) -> int:
    payload = {
        "version": BASELINE_VERSION,
        "comment": "Grandfathered torchlint findings. Keep this "
                   "near-empty: fix findings, baseline only justified "
                   "exceptions, each with its justification.",
        "entries": entries,
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=False)
        f.write("\n")
    return len(entries)


def write_baseline(path: str, findings: Iterable[Finding],
                   justification: str = "grandfathered by --write-baseline"
                   ) -> int:
    """Write a baseline holding exactly ``findings`` (no merge — callers
    that linted a subset of the repo should go through
    :func:`merge_entries` first, as the CLI does)."""
    return write_entries(path, [
        {"check": f.check, "path": f.path, "source": f.source,
         "justification": justification}
        for f in findings
    ])


def apply_baseline(findings: Iterable[Finding], entries: List[dict]
                   ) -> Tuple[List[Finding], List[Finding], List[dict]]:
    """(new, matched, stale): findings not covered by the baseline,
    findings it covers, and entries that matched nothing (candidates
    for pruning — usually a fixed line)."""
    keys = {}
    for entry in entries:
        keys.setdefault(
            (entry["check"], entry["path"], entry["source"]), []).append(entry)
    new: List[Finding] = []
    matched: List[Finding] = []
    used = set()
    for f in findings:
        key = (f.check, f.path, f.source)
        if key in keys:
            matched.append(f)
            used.add(key)
        else:
            new.append(f)
    stale = [e for key, group in keys.items() if key not in used
             for e in group]
    return new, matched, stale
